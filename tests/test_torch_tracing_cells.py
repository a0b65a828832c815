"""The benchmark's two readers of the port's tracer, on a traced CPU
rehearsal of each cell (``perfbench/run.py`` at the port's reduced sizes):
``kv_live_row_share`` equals the share of live cache rows reckoned from the
serving loop's own records of the profiled ticks (each decoding slot's
position), and ``tick_kernels`` reads nothing, since no graph is captured
on the CPU."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402

torch.set_num_threads(1)

# closed loops: enough requests that the pool still serves once the
# profiler (about 2 s to start on the CPU) records
CELLS = {"granite8b.chat": None, "granite-moe.batch": {"requests": 2000},
         "granite8b.longdoc": {"requests": 1000}}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_rehearsal_reads_the_live_row_share_of_the_loops_ticks(cell, monkeypatch):
    seen = {}
    real = run.load_reader

    def spying(root, name):
        read = real(root, name)

        def wrapped(r):
            seen["run"] = r
            return read(r)
        return wrapped

    monkeypatch.setattr(run, "load_reader", spying)
    sys.path.insert(0, str(ROOT / "src"))
    out = run.run_cell(ROOT, cell, 2147483901, 4.0, True, device="cpu", rehearsal=True,
                       t_process=time.perf_counter(), traffic_over=CELLS[cell])
    assert out["correct"] is True
    r = seen["run"]
    x0, x1 = r.excluded
    ticks = [w for w in r.work if w.kind == "tick" and x0 <= w.t0 and w.t1 <= x1]
    assert ticks, "no tick while the profiler recorded"
    pool = r.traffic["pool"]
    live = sum(p + 1 for w in ticks for p in w.args["positions"])
    scored = len(ticks) * pool["max_batch"] * pool["max_len"]
    assert out["metrics"]["kv_live_row_share"]["value"] == pytest.approx(
        100.0 * live / scored, rel=1e-12)
    assert out["metrics"]["kv_live_row_share"]["unit"] == "%"
    assert "tick_kernels" not in out["metrics"]
