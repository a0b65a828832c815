"""CPU tests of the benchmark's harness: discovery by name, the result
line, the rehearsal of a whole run at the port's reduced sizes, the
control and the faults that the comparison must catch, and the measuring
command's refusal without a card."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in run.load_json(ROOT / "BENCHMARK.json")["workloads"]]


def _rehearse(name: str, seed: int, seconds: float = 1.5, **kw) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    return run.run_cell(ROOT, name, seed, seconds, kw.pop("trace", False), device="cpu",
                        rehearsal=True, t_process=time.perf_counter(), **kw)


def test_every_cell_metric_and_file_is_found_by_name():
    bench = run.load_json(ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + CELLS + [c["name"] for c in bench["configs"]]:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert run.reader_path(ROOT, m["name"]).is_file()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for cell in CELLS:
        c = run.Cell(ROOT, cell)
        assert c.cfg["name"] == c.workload["config"]
        assert "max_logit_gap" in c.limits
        reported = {m["name"] for m in c.metrics("end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = c.metrics("per_layer")
        assert layer and all(m["moves"] in reported for m in layer)
    for cfg in bench["configs"]:
        body = run.load_json(ROOT / cfg["file"])
        assert body["source"] == cfg["source"] and body["reduced"] == cfg["reduced"]
    texts = [e["why"] for e in bench["configs"] + bench["workloads"]]
    texts += [m["layer"] for m in bench["per_layer"]] + bench["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    # a full check of 24 cells at this window fits in 12 hours
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_of_a_run_is_correct_and_prints_the_contract_keys(cell):
    out = _rehearse(cell, 11)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["requests_compared"]["value"] >= 1
    assert out["notes"]["served_tokens_compared"] >= 1
    c = run.Cell(ROOT, cell)
    assert set(out["metrics"]) <= {m["name"] for m in c.metrics("end_to_end")}
    assert "output_tokens_per_s" in out["metrics"] and "setup_s" in out["metrics"]


def test_traced_rehearsal_reads_the_per_layer_metrics_and_a_breakdown():
    # the profiler takes about 2 s to start on the CPU, and the host-clock
    # readers leave that out: the window has to reach past it
    out = _rehearse("granite8b.chat", 12, seconds=5.0, trace=True)
    assert {"prefill_ms.chat", "tick_ms", "model_mfu", "model_hbm_share"} <= set(out["metrics"])
    assert "window_s" in out["device"] and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["granite8b.chat", "granite-moe.batch"])
def test_the_control_fails_the_limit(cell):
    """The reference with int4 weights in the program's place reads above
    the limit that sound runs keep under."""
    out = _rehearse(cell, 13, control=True)
    limit = out["checks"]["max_logit_gap"]["limit"]
    assert out["correct"] is True, (out["checks"], out["failed"], out["attempted"])
    assert out["checks"]["max_logit_gap"]["value"] <= limit
    # the harness's own verdict on the control, through the program's comparison
    assert out["control"]["correct"] is False
    assert out["control"]["max_logit_gap"] > limit


def test_a_metric_named_for_a_cell_is_read_by_its_stems_reader(tmp_path):
    folder = tmp_path / "perfbench" / "metrics"
    folder.mkdir(parents=True)
    (folder / "prefill_ms.py").write_text("def read(run):\n    return 1.0\n")
    (folder / "prefill_ms.chat.py").write_text("def read(run):\n    return 2.0\n")
    assert run.reader_path(tmp_path, "prefill_ms.batch") == folder / "prefill_ms.py"
    assert run.load_reader(tmp_path, "prefill_ms.batch")(None) == 1.0
    assert run.load_reader(tmp_path, "prefill_ms.chat")(None) == 2.0
    assert not run.reader_path(tmp_path, "tick_ms").is_file()


def test_the_profilers_interval_is_left_out_of_host_clock_readings():
    from perfbench.loop import Work

    class Meter:
        samples = [(1.0, 300.0), (5.0, 100.0), (8.0, 320.0)]

    spans = [("tick", 1.0, 1.1), ("tick", 4.5, 4.6), ("tick", 5.5, 5.7), ("tick", 8.0, 8.2)]
    work = [Work("tick", a, b, {"positions": [0]}) for _, a, b in spans]
    kw = dict(t0=0.0, t1=10.0, spans=spans, work=work, power=Meter())
    plain, traced = run.Run(**kw), run.Run(**kw, excluded=(4.0, 6.0))
    assert plain.clear_s == 10.0 and traced.clear_s == 8.0
    assert len(plain.work_in_window()) == 4 and len(traced.work_in_window()) == 2
    assert traced.span_seconds("tick") == pytest.approx([0.1, 0.2])
    assert plain.power_samples() == [300.0, 100.0, 320.0]
    assert traced.power_samples() == [300.0, 320.0]
    # an interval that runs past the window's close is cut at it
    assert run.Run(**dict(kw, excluded=(9.0, 12.0))).clear_s == 9.0


@pytest.mark.parametrize("name", ["gqa_lm"])
def test_a_model_module_brings_what_the_harness_calls(name):
    import importlib

    mod = importlib.import_module(f"perfbench.models.{name}")
    for fn in ("sizes", "make_weights", "reference_logits", "arch_overrides", "check_arch",
               "rehearsal_config", "program_tree", "k5_calls", "work_ops", "work_bytes",
               "work_k5_calls"):
        assert callable(getattr(mod, fn)), fn
    for cfg in run.load_json(ROOT / "BENCHMARK.json")["configs"]:
        body = run.load_json(ROOT / cfg["file"])
        assert (ROOT / "perfbench" / "models" / f"{body['model']}.py").is_file()


def _altered_token(monkeypatch):
    from repro_torch.serving.engine import InferenceEngine

    step = InferenceEngine.masked_decode_step

    def broken(self, pool):
        nxt, fin = step(self, pool)
        return (nxt + 1) % self.cfg.vocab_size, fin
    monkeypatch.setattr(InferenceEngine, "masked_decode_step", broken)


def _state_unchanged(monkeypatch):
    """The decode step leaves its cache as it was: no K/V row is written."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "write_cache", lambda cache, new, pos, cfg, split=None: cache)


def _half_batch(monkeypatch):
    """The tick computes every other slot as if it were free."""
    from repro_torch.serving.engine import InferenceEngine

    tick = InferenceEngine._decode_tick

    def broken(self, cache, tok, pos, active):
        active = active.clone()
        active[1::2] = False
        return tick(self, cache, tok, pos, active)
    monkeypatch.setattr(InferenceEngine, "_decode_tick", broken)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged, _half_batch])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    sys.path.insert(0, str(ROOT / "src"))
    fault(monkeypatch)
    out = _rehearse("granite8b.chat", 14)
    assert out["correct"] is False
    assert out["checks"]["max_logit_gap"]["value"] > out["checks"]["max_logit_gap"]["limit"]


def test_rehearsal_loads_no_jax_module_in_a_fresh_process():
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "from perfbench import run\n"
            "out = run.rehearse('granite-moe.batch', seed=15, seconds=1.5)\n"
            "print(json.dumps({'correct': out['correct'], 'forbidden': run.forbidden_modules(),"
            " 'loaded': sorted({m.split('.')[0] for m in sys.modules})}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is True and last["forbidden"] == []
    assert "repro_torch" in last["loaded"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(last["loaded"])


def test_the_measuring_command_prints_no_result_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "granite8b.chat",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]
