"""The control of a cell's comparison, and the readings its limit is set from.

    python3 perfbench/control.py --workload granite8b.chat --seeds 101,102,103 --seconds 15

One process runs the cell once a seed (its own set-up and a short window at
the cell's load) and prints, per seed, the program's widest gap and verdict
and the control's: the reference with int4 weights, read at each position
of the same sampled sequences (``check.gaps``) and judged by the same
``check.verdict`` against the cell's limit.  The limit in
``perfbench/limits/<workload>.json`` lies between the program's largest
reading and the control's smallest.  It exits 1 when any seed's control
reads correct: the comparison would then not catch the control.  The
benchmark's own runs never run it.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import run

    run.set_cache_dirs(ROOT)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(ROOT, args.workload, seed, args.seconds, False, control=True,
                           t_process=time.perf_counter(),
                           log=lambda m: print(m, file=sys.stderr))
        row = {"seed": seed, "program": out["checks"]["max_logit_gap"]["value"],
               "correct": out["correct"], "control": out["control"]["max_logit_gap"],
               "control_correct": out["control"]["correct"],
               "limit": out["checks"]["max_logit_gap"]["limit"],
               "served": out["notes"]["served_tokens_compared"],
               "detail": out["control"], "metrics": out["metrics"]}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "detail"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    caught = not any(r["control_correct"] for r in rows)
    print(json.dumps({"workload": args.workload,
                      "program_max": max((r["program"] for r in rows if r["program"] is not None),
                                         default=None),
                      "control_min": min((r["control"] for r in rows if r["control"] is not None),
                                         default=None),
                      "program_correct_on_every_seed": all(r["correct"] for r in rows),
                      "control_not_correct_on_every_seed": caught}))
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
