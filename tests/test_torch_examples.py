"""The port's examples (``examples/torch/``) run on the CPU at a small size,
their ``main`` called in this process, and the deterministic numbers they
print held to the reference's modules called directly (not to the
reference's scripts): C1–C4 and the Generator's picks on both backends
(``quickstart``), the RQ3 loop (``generate_accelerator``), the request
stream, break-even τ and the strategy table at a fixed latency
(``serve_workload --n 8``, the scheduler's costs preset), and the model,
schedule and restart of ``train_lm --quick --steps 20``."""
import contextlib
import importlib.util
import io
import math
import pathlib

import numpy as np

from repro.configs import get_config as jax_config
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core import constraints as jcons
from repro.core import cost_model as jcm
from repro.core import fpga as jfpga
from repro.core import generator as jgen
from repro.core import workload as jwl
from repro.core.candidates import DesignPoint as JaxDesignPoint
from repro.core.energy import TPUChip
from repro.serving import load as jload
from repro.serving.scheduler import FixedCalibration as JaxFixedCalibration
from repro.training.optimizer import Schedule as JaxSchedule
from repro_torch.core.energy import DEFAULT_CHIP
from repro_torch.serving import engine as tengine
from repro_torch.serving.scheduler import FixedCalibration

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's TPU chip carrying H100Chip's numbers
H100_AS_TPU = TPUChip(
    name=DEFAULT_CHIP.name, peak_flops=DEFAULT_CHIP.peak_flops,
    peak_int8_ops=DEFAULT_CHIP.peak_int8_ops, hbm_bw=DEFAULT_CHIP.hbm_bw,
    hbm_bytes=DEFAULT_CHIP.hbm_bytes, ici_bw=DEFAULT_CHIP.link_bw,
    p_idle_w=DEFAULT_CHIP.p_idle_w, p_peak_w=DEFAULT_CHIP.p_peak_w,
    reload_bw=DEFAULT_CHIP.reload_bw, reload_fixed_s=DEFAULT_CHIP.reload_fixed_s)


def example(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(name: str, argv: list, mod=None) -> tuple[int, list[str]]:
    mod = mod or example(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue().splitlines()


def test_quickstart_matches_the_reference():
    rc, out = run("quickstart", ["--device", "cpu"])
    assert rc == 0
    w = jfpga.paper_workload()
    base, opt = jfpga.baseline_template(), jfpga.optimized_template()
    assert f"latency : {base.latency_s(w) * 1e6:.2f} -> {opt.latency_s(w) * 1e6:.2f} µs " \
           f"(published 53.32 -> 28.07)" in out
    assert f"GOPS/s/W: {base.gops_per_w(w):.2f} -> {opt.gops_per_w(w):.2f} " \
           f"({opt.gops_per_w(w) / base.gops_per_w(w):.2f}x, published 2.33x)" in out
    prof = jwl.AccelProfile.from_template(opt, w)
    assert f"items in the same energy budget: {jwl.c3_ratio(prof, 0.040):.2f}x " \
           f"(published 12.39x)" in out
    c4 = float(next(ln for ln in out if ln.startswith("improvement: +"))[14:].split("%")[0])
    assert abs(c4 - 100 * jwl.c4_improvement(prof)["improvement"]) <= 0.06  # learn_tau to 1e-3
    # the FPGA Generator (refined by learn_tau) and the GPU one, whose report
    # the reference's TPUCostBackend gives on a chip carrying H100Chip's numbers
    fpga = jgen.Generator(jfpga.FPGACostBackend(workload=w),
                          jcons.scenario_regular_sensor(0.040)).search(method="exhaustive")
    at = out.index("== Generator on the FPGA backend (40 ms sensor scenario) ==")
    assert out[at + 1] == fpga.report(top=3).splitlines()[0]
    best = out[at + 2].strip()
    assert best.startswith(f"{fpga.best.point!r} × {fpga.best.strategy}")
    gpu = jgen.Generator(
        jcm.TPUCostBackend(jax_config("granite-3-8b"), "decode_32k", jcm.MeshPlan(dp=16, tp=16),
                           H100_AS_TPU),
        jcons.ApplicationSpec(name="cluster-serve", goal="energy_efficiency", period_s=2.0,
                              max_latency_s=1.0)).search(method="exhaustive", refine=False)
    at = out.index("== Generator on the GPU backend (beyond-paper: cluster serving) ==")
    assert out[at + 1:at + 5] == gpu.report(top=3).splitlines()


def test_generate_accelerator_matches_the_reference():
    rc, out = run("generate_accelerator", ["--device", "cpu"])
    assert rc == 0
    w = jfpga.paper_workload()
    backend = jfpga.FPGACostBackend(workload=w)
    gaps = jwl.bursty_trace(jwl.AccelProfile.from_template(jfpga.optimized_template(), w),
                            n=3000, seed=7)
    app = jcons.ApplicationSpec(name="vibration-sensor", goal="energy_efficiency",
                                max_latency_s=10e-3, max_act_error=5e-3,
                                resource_budget={"lut": 8000, "bram_kb": 360}, gaps=gaps)
    best_hw = jgen.Generator(backend, jcons.ApplicationSpec(name="cont", goal="gops_per_w")
                             ).search(refine=False).best
    assert f"    best template: {best_hw.point} -> {best_hw.score:.2f} GOPS/W" in out
    opt = jfpga.optimized_template()
    paper_point = JaxDesignPoint.of(n_mac=opt.n_mac, n_act=opt.n_act, act_impl=opt.act_impl,
                                    pipelined=opt.pipelined)
    fixed = jgen.score_candidate(paper_point, backend.evaluate(paper_point), app)
    assert f"    best strategy on paper template: {fixed.strategy} " \
           f"-> {fixed.score:.2f} items/J" in out
    res = jgen.Generator(backend, app).search(method="exhaustive")
    at = out.index("[3] combined Generator search (templates x strategies):")
    assert out[at + 1].strip().startswith(f"{res.best.point!r} × {res.best.strategy}")
    assert out[at + 2] == (f"    searched {res.visited}/{res.space_size}, pruned "
                           f"{len(res.pruned)} (first prune reason: {res.pruned[0][1]})")
    sim = jwl.simulate(gaps, res.best.strategy, jgen.profile_of(res.best.estimate),
                       tau=res.best.tau,
                       max_stretch=app.max_latency_s - res.best.estimate.latency_s)
    line = next(ln for ln in out if ln.startswith("validation: "))
    assert line.startswith(f"validation: {sim.items} items, ")
    assert line.endswith(f"{sim.missed_deadlines} deadline misses")
    assert out[-1] == "analytical estimate matches simulation within 5% ✓"


T_INF = 0.009  # s: the measured batch latency, fixed
FIXED_COSTS = {"step_s": 0.002, "prefill_base_s": 0.001, "prefill_per_tok_s": 0.0002}


def test_serve_workload_matches_the_reference(monkeypatch):
    """``--n 8`` on the CPU with the scheduler's costs preset and the batch
    latency fixed (both are measured on a device): every request served in
    both modes; the request stream, break-even τ and each strategy's items/J
    and reloads those of the reference's load and workload modules."""
    ex = example("serve_workload")
    streams, servers = [], []

    def stream(*a, **kw):
        streams.append(ex_stream(*a, **kw))
        return streams[-1]

    class Server(tengine.WorkloadAwareServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    ex_stream = ex.bursty_stream_for_service
    monkeypatch.setattr(ex, "EngineCalibration", lambda engine: FixedCalibration(**FIXED_COSTS))
    monkeypatch.setattr(ex, "bursty_stream_for_service", stream)
    monkeypatch.setattr(ex, "WorkloadAwareServer", Server)
    monkeypatch.setattr(tengine.WorkloadAwareServer, "measure_latency",
                        lambda self, **kw: T_INF)
    n = 8
    rc, out = run("serve_workload", ["--n", str(n), "--device", "cpu"], ex)
    assert rc == 0
    assert out[0] == ("engine: granite-3-8b (reduced: 2L × 64d, int8 weights) on cpu, "
                      "greedy decode, 4-slot pool")
    summaries = [ln.split() for ln in out if ln.startswith(("  continuous", "  static"))]
    assert [s[:2] for s in summaries] == [["continuous", f"items={n}"], ["static", f"items={n}"]]

    want = jload.bursty_stream_for_service(JaxFixedCalibration(**FIXED_COSTS), n,
                                           vocab_size=512, seed=0, new_tokens=(4, 16))
    (got,) = streams
    assert [(r.rid, r.arrival_s, r.new_tokens, r.deadline_s, r.tier) for r in got] == \
        [(r.rid, r.arrival_s, r.new_tokens, r.deadline_s, r.tier) for r in want]
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(got, want))

    p = servers[0].profile(T_INF)
    prof = jwl.AccelProfile(t_inf_s=p.t_inf_s, p_active_w=p.p_active_w, p_idle_w=p.p_idle_w,
                            e_cfg_j=p.e_cfg_j, t_cfg_s=p.t_cfg_s)
    tau = jwl.break_even_tau(prof)
    assert f"break-even τ = {tau:.2f} s" in next(ln for ln in out if "break-even" in ln)
    regimes = {
        "fast-regular (gap ≈ 0.1·τ):": jwl.regular_trace(0.1 * tau + T_INF, T_INF, n),
        "slow-regular (gap ≈ 10·τ):": jwl.regular_trace(10 * tau + T_INF, T_INF, n),
        "bursty:": jwl.bursty_trace(prof, n=n, seed=0),
    }
    for name, gaps in regimes.items():
        at = out.index(name)
        for i, strat in enumerate(("on_off", "idle_waiting", "slow_down", "adaptive")):
            res = jwl.simulate(gaps, strat, prof, tau=tau)
            reloads = {"on_off": gaps.size, "adaptive": int(np.count_nonzero(gaps > tau))
                       }.get(strat, 0)
            assert out[at + 1 + i].startswith(
                f"  {strat:14s} {res.items_per_joule:10.4f} items/J  reloads={reloads:4d}"), \
                (name, strat)


def test_train_lm_matches_the_reference(tmp_path):
    """``--quick --steps 20``: granite-4m's parameter count, the logged
    steps (the failure injected at step 10 restores the last checkpoint and
    the run goes on to step 19), every logged lr the reference's schedule's,
    and the verdict line."""
    rc, out = run("train_lm", ["--quick", "--steps", "20", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path / "ckpt")])
    ref = JaxArchConfig(name="granite-4m", family="dense", num_layers=4, d_model=192,
                        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=1024, remat="none")
    assert out[0] == (f"granite-4m: {ref.param_count() / 1e6:.1f}M params, 20 steps, "
                      f"batch 16×128 tokens, on cpu")
    assert out[1] == "(worker failure injected at step 10; expect restore+replay)"
    assert "restarts: 1" in out
    at = out.index(f"{'step':>6s} {'loss':>8s} {'grad':>8s} {'lr':>9s} {'s/step':>7s}")
    rows = [ln.split() for ln in out[at + 1:] if ln.strip() and ln.split()[0].isdigit()]
    steps = [int(r[0]) for r in rows]
    assert steps[-10:] == list(range(10, 20)) and steps[0] == 0
    sched = JaxSchedule(peak_lr=3e-3, warmup_steps=5, total_steps=20)
    for r in rows:
        assert r[3] == f"{float(sched(int(r[0]))):.2e}", r
        assert math.isfinite(float(r[1]))
    final = float(rows[-1][1])
    assert out[-2].endswith(f"final = {final:.3f}")
    assert (rc == 0) == (final < 0.6 * math.log(1024))
