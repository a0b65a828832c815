"""The paper's Generator stack in the port (``repro_torch.core``) against the
reference's: the same seeds through both packages' exhaustive, beam and
evolutionary searches on ``FPGACostBackend`` under the four ``constraints``
scenarios give the same best design points, with ``Estimate`` fields equal
to 1e-12 relative; ``learn_tau`` (``torch.autograd`` here, ``jax.grad``
there) agrees to 1e-3 relative and picks the same strategy; and the paper's
claims C1–C4 (``tests/test_paper_claims.py``) reproduce from the port."""
import dataclasses

import numpy as np
import pytest

from repro.core import constraints as jcons
from repro.core import fpga as jfpga
from repro.core import generator as jgen
from repro.core import workload as jwl
from repro_torch.core import constraints as tcons
from repro_torch.core import fpga as tfpga
from repro_torch.core import generator as tgen
from repro_torch.core import workload as twl
from repro_torch.core.candidates import DesignPoint

W = tfpga.paper_workload()
OPT = tfpga.optimized_template()
BASE = tfpga.baseline_template()
PROF = twl.AccelProfile.from_template(OPT, W)
JPROF = jwl.AccelProfile.from_template(jfpga.optimized_template(), jfpga.paper_workload())
GAPS = twl.irregular_trace(PROF, n=1000, seed=0)

SCENARIOS = {
    "regular": lambda c: c.scenario_regular_sensor(0.040),
    "irregular": lambda c: c.scenario_irregular(GAPS),
    "latency": lambda c: c.scenario_latency_critical(100e-6),
    "continuous": lambda c: c.scenario_continuous_throughput(),
}
ESTIMATE_FIELDS = ("latency_s", "power_active_w", "power_idle_w", "energy_per_inf_j",
                   "max_act_error", "cfg_energy_j", "cfg_time_s", "ops", "gops_per_w")


def _close(a: float, b: float, rel: float) -> bool:
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


def _search(pkg_gen, pkg_fpga, pkg_cons, scenario, method, **kw):
    backend = pkg_fpga.FPGACostBackend(workload=pkg_fpga.paper_workload())
    return pkg_gen.Generator(backend, SCENARIOS[scenario](pkg_cons), **kw).search(
        method=method, seed=1, refine=False)


@pytest.mark.parametrize("method", ["exhaustive", "beam", "evolutionary"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_search_matches_the_reference(scenario, method):
    got = _search(tgen, tfpga, tcons, scenario, method)
    want = _search(jgen, jfpga, jcons, scenario, method)
    assert (got.visited, got.space_size, len(got.pruned)) == \
        (want.visited, want.space_size, len(want.pruned))
    assert [c.point.values for c in got.ranked] == [c.point.values for c in want.ranked]
    assert [c.strategy for c in got.ranked] == [c.strategy for c in want.ranked]
    assert got.best.point.values == want.best.point.values
    for field in ESTIMATE_FIELDS:
        assert _close(getattr(got.best.estimate, field), getattr(want.best.estimate, field),
                      1e-12), field
    assert dict(got.best.estimate.resources) == dict(want.best.estimate.resources)
    assert _close(got.best.score, want.best.score, 1e-12)
    assert [p.values for p, _ in got.pareto] == [p.values for p, _ in want.pareto]


def test_refined_search_matches_the_reference():
    """The learnable-τ refinement of the top candidates (C4's machinery, the
    one place the Generator differentiates) lands on the reference's point
    and strategy.  On this 1000-gap trace the reference's f32 τ drifts 2%
    from exact arithmetic (``test_learn_tau_where_the_reference_drifts``);
    the port's buys at least the reference's items per joule."""
    backend = jfpga.FPGACostBackend(workload=jfpga.paper_workload())
    want = jgen.Generator(backend, jcons.scenario_irregular(GAPS), refine_k=2).search(
        method="exhaustive", seed=1, refine=True)
    got = tgen.Generator(tfpga.FPGACostBackend(workload=W), tcons.scenario_irregular(GAPS),
                         refine_k=2, device="cpu").search(method="exhaustive", seed=1, refine=True)
    assert got.best.point.values == want.best.point.values
    assert got.best.strategy == want.best.strategy == "adaptive"
    assert [c.point.values for c in got.ranked] == [c.point.values for c in want.ranked]
    assert got.best.score >= want.best.score


def _learn_tau_f64(gaps, prof, steps=600, lr=0.05, beta0=0.05, beta1=0.002):
    """``learn_tau``'s algorithm in float64: what exact arithmetic gives."""
    import torch

    gaps = torch.as_tensor(np.asarray(gaps), dtype=torch.float64)
    log_tau = float(np.log(twl.break_even_tau(prof)))
    m = v = 0.0
    for t in range(1, steps + 1):
        beta = beta0 * (beta1 / beta0) ** ((t - 1) / max(steps - 1, 1))
        lt = torch.tensor(log_tau, dtype=torch.float64, requires_grad=True)
        twl._soft_energy(torch.exp(lt), gaps, prof, beta).backward()
        g = float(lt.grad)
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
        log_tau -= lr * (m / (1 - 0.9**t)) / ((v / (1 - 0.999**t)) ** 0.5 + 1e-8)
    return float(np.exp(log_tau))


@pytest.mark.parametrize("trace", ["irregular", "bursty"])
def test_learn_tau_matches_the_reference(trace):
    make = {"irregular": twl.irregular_trace, "bursty": twl.bursty_trace}[trace]
    gaps = make(PROF)  # the default traces: 4000 gaps, seed 0
    got = twl.learn_tau(gaps, PROF, device="cpu")
    want = jwl.learn_tau(gaps, JPROF)
    assert _close(got, want, 1e-3), (got, want)
    # the same strategy wins the trace at either threshold
    for tau in (got, want):
        picks = {s: twl.simulate(gaps, s, PROF, tau=tau if s == "adaptive" else None).energy_j
                 for s in tgen.STRATEGIES}
        assert min(picks, key=picks.get) == "adaptive"


@pytest.mark.parametrize("trace", ["irregular-1000", "bursty-800"])
def test_learn_tau_where_the_reference_drifts(trace):
    """On short traces the annealed loss is flat and spiky near its minimum,
    and f32 summation orders move the trained τ: on the Generator test's
    1000-gap irregular trace (at the refined design's profile) the
    reference's τ is 2.2% from the float64 run of the same algorithm, on
    ``tests/test_generator.py``'s 800-gap bursty trace 0.7%.  The port's
    f32 τ is never farther from the reference's than exact arithmetic is."""
    from repro_torch.core.candidates import DesignPoint

    if trace == "irregular-1000":
        est = tfpga.FPGACostBackend(workload=W).evaluate(
            DesignPoint.of(n_mac=32, n_act=2, act_impl="hard", pipelined=True))
        prof, gaps = tgen.profile_of(est), GAPS
        jprof = jgen.profile_of(est)
    else:
        prof, jprof, gaps = PROF, JPROF, twl.bursty_trace(PROF, n=800, seed=2)
    got = twl.learn_tau(gaps, prof, device="cpu")
    want = jwl.learn_tau(gaps, jprof)
    exact = _learn_tau_f64(gaps, prof)
    assert abs(got - want) <= abs(exact - want)


def test_weighted_soft_energy_matches_the_reference():
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(5)
    gaps = rng.uniform(0.0, 2.0, 64).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    for w in (None, weights, np.zeros(64, np.float32)):
        got = twl._soft_energy(torch.tensor(0.4), torch.from_numpy(gaps), PROF, 0.02,
                               None if w is None else torch.from_numpy(w))
        want = jwl._soft_energy(jnp.float32(0.4), jnp.asarray(gaps), JPROF, 0.02,
                                None if w is None else jnp.asarray(w))
        assert _close(float(got), float(want), 1e-6)


def test_learn_tau_needs_a_device():
    """``device=None`` means the card: without one it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        twl.learn_tau(GAPS[:10], PROF, steps=2)


def test_traces_and_simulation_match_the_reference():
    for got, want in ((twl.irregular_trace(PROF, n=500, seed=4),
                       jwl.irregular_trace(JPROF, n=500, seed=4)),
                      (twl.bursty_trace(PROF, n=500, seed=4), jwl.bursty_trace(JPROF, n=500, seed=4)),
                      (twl.regular_trace(0.04, 1e-5, 10), jwl.regular_trace(0.04, 1e-5, 10))):
        np.testing.assert_array_equal(got, want)
    for strategy in ("on_off", "idle_waiting", "slow_down", "adaptive"):
        tau = 0.3 if strategy == "adaptive" else None
        assert dataclasses.astuple(twl.simulate(GAPS, strategy, PROF, tau=tau)) == \
            dataclasses.astuple(jwl.simulate(GAPS, strategy, JPROF, tau=tau))


# ---------------------------------------------------------------------------
# C1–C4 from the port (tests/test_paper_claims.py)
# ---------------------------------------------------------------------------
def test_c1_latency_reproduction():
    base_us, opt_us = BASE.latency_s(W) * 1e6, OPT.latency_s(W) * 1e6
    assert base_us == pytest.approx(53.32, rel=0.01)
    assert opt_us == pytest.approx(28.07, rel=0.01)
    assert 1 - opt_us / base_us == pytest.approx(0.4737, abs=0.01)


def test_c2_energy_efficiency_reproduction():
    assert BASE.gops_per_w(W) == pytest.approx(5.57, rel=0.01)
    assert OPT.gops_per_w(W) == pytest.approx(12.98, rel=0.01)
    assert OPT.gops_per_w(W) / BASE.gops_per_w(W) == pytest.approx(2.33, rel=0.01)


def test_c3_idle_waiting_ratio():
    assert twl.c3_ratio(PROF, request_period_s=0.040) == pytest.approx(12.39, rel=0.01)
    assert twl.c3_ratio(PROF, 0.040) > twl.c3_ratio(PROF, 0.400) > twl.c3_ratio(PROF, 4.0)


def test_c4_learnable_threshold_improvement():
    got = twl.c4_improvement(PROF, seed=0, device="cpu")
    want = jwl.c4_improvement(JPROF, seed=0)
    assert 0.04 <= got["improvement"] <= 0.08, got
    assert got["tau_learned"] != pytest.approx(got["tau_predefined"], rel=0.05)
    assert _close(got["tau_learned"], want["tau_learned"], 1e-3)
    assert _close(got["improvement"], want["improvement"], 1e-3)


def test_learned_tau_beats_break_even_on_train_distribution():
    gaps = twl.irregular_trace(PROF, n=2000, seed=3)
    tau_l = twl.learn_tau(gaps, PROF, steps=300, device="cpu")
    e_learned = twl.simulate(gaps, "adaptive", PROF, tau=tau_l).energy_j
    e_pre = twl.simulate(gaps, "adaptive", PROF, tau=twl.break_even_tau(PROF)).energy_j
    assert e_learned <= e_pre * 1.001


def test_pipelining_and_activation_each_contribute():
    only_pipe = dataclasses.replace(BASE, pipelined=True)
    only_act = dataclasses.replace(BASE, act_impl="hard")
    assert only_pipe.latency_s(W) < BASE.latency_s(W)
    assert only_act.latency_s(W) < BASE.latency_s(W)
    assert OPT.latency_s(W) < min(only_pipe.latency_s(W), only_act.latency_s(W))


def test_template_space_has_resource_infeasible_points():
    infeasible = [t for t in tfpga.template_space() if not t.feasible()]
    assert infeasible
    backend = tfpga.FPGACostBackend(workload=W)
    for t in infeasible[:5]:
        ok, why = backend.feasible(DesignPoint.of(n_mac=t.n_mac, n_act=t.n_act,
                                                  act_impl=t.act_impl, pipelined=t.pipelined))
        assert not ok and why
    mlp = tfpga.FPGACostBackend(workload=tfpga.MLPWorkload(), component="mlp")
    want = jfpga.FPGACostBackend(workload=jfpga.MLPWorkload(), component="mlp")
    point = DesignPoint.of(n_mac=8, n_act=4, act_impl="pwl", pipelined=True)
    assert dataclasses.astuple(mlp.evaluate(point)) == dataclasses.astuple(want.evaluate(point))
