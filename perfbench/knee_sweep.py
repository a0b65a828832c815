"""Find an open-loop cell's knee once: the highest arrival rate the system
sustains.  One process, one run of the cell a rate, each with its own ramp
and window at the cell's sizes.

    python3 perfbench/knee_sweep.py --workload granite8b.chat --rates 2,3,4,5,6 --seconds 20

Per rate it prints the tokens a second, the TTFT's 90th percentile, the
95th percentile of the gaps between tokens and the requests still waiting
at the window's end.  Past the knee the queue grows through
the window and TTFT climbs with it.  The cell's rate is then set to about
four fifths of the knee, in its traffic file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=4242)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import run

    run.set_cache_dirs(ROOT)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        out = run.run_cell(ROOT, args.workload, args.seed, args.seconds, False,
                           t_process=time.perf_counter(), traffic_over={"rate_hz": rate},
                           log=lambda m: print(m, file=sys.stderr))
        row = {"rate_hz": rate, **{k: v["value"] for k, v in out["metrics"].items()},
               "attempted": out["attempted"], "waiting_at_end": out["notes"]["waiting_at_end"],
               "correct": out["correct"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
