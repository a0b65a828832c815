"""The port's duty-cycle layer against the reference's: the online policies
(``serving/policy.py``), ``gpu_reload_costs`` beside ``tpu_reload_costs``,
and ``ServerStats`` / ``WorkloadAwareServer`` (``serving/engine.py``).

Tolerances, each stated where it is used:

* the fixed policies' per-gap charges are host arithmetic: equal to the
  reference's exactly, and their sum to one ``simulate`` call to 1e-9
  relative (a sum in another order);
* a learned τ goes through ``torch.autograd`` here and ``jax.grad`` there:
  within 1e-3 relative, as ``tests/test_torch_generator.py`` holds
  ``learn_tau``, wherever the reference's own fit is determined to that
  margin (``test_streaming_tau_matches_the_reference`` says where it is
  not); the streaming policy decides every gap outside that margin of the
  two thresholds alike, and its items/J are within 10% of the offline
  ``learn_tau`` run's (the reference's own acceptance bar);
* reload costs and ``ServerStats`` at the same latency and chip constants:
  exact, or 1e-3 relative where a learned τ is in the ledger.

Every engine here is a reduced config on the CPU (``device="cpu"``); the
reference's server needs only ``engine.cfg`` when the latency is given, so
it gets a stand-in holding the reference's config."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import energy as jenergy
from repro.core import fpga as jfpga
from repro.core import workload as jwl
from repro.serving import engine as jengine
from repro.serving import policy as jpolicy
from repro_torch.configs import get_config, get_reduced_config, list_archs
from repro_torch.core import energy as tenergy
from repro_torch.core import fpga as tfpga
from repro_torch.core import workload as twl
from repro_torch.serving import engine as tengine
from repro_torch.serving import policy as tpolicy

PROF = twl.AccelProfile.from_template(tfpga.optimized_template(), tfpga.paper_workload())
JPROF = jwl.AccelProfile.from_template(jfpga.optimized_template(), jfpga.paper_workload())
TAU_REL = 1e-3
# H100Chip with the reference TPU chip's duty-cycle constants: the same
# arithmetic must then give the same numbers
TPU = jenergy.DEFAULT_CHIP
TPU_LIKE = dataclasses.replace(tenergy.DEFAULT_CHIP, p_idle_w=TPU.p_idle_w,
                               p_peak_w=TPU.p_peak_w, reload_bw=TPU.reload_bw,
                               reload_fixed_s=TPU.reload_fixed_s)


def close(a: float, b: float, rel: float) -> bool:
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


def trace(kind: str, prof, n: int, seed: int) -> np.ndarray:
    mod = twl if isinstance(prof, twl.AccelProfile) else jwl
    return {"bursty": mod.bursty_trace, "irregular": mod.irregular_trace}[kind](prof, n, seed)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------
def test_policy_names_match_the_reference():
    assert sorted(tpolicy.POLICIES) == sorted(jpolicy.POLICIES)
    for name, cls in tpolicy.POLICIES.items():
        assert cls.__name__ == jpolicy.POLICIES[name].__name__


@pytest.mark.parametrize("name", ["on_off", "idle_waiting", "slow_down"])
@pytest.mark.parametrize("kind,seed", [("bursty", 1), ("irregular", 2)])
def test_fixed_policies_match_the_reference_and_simulate(name, kind, seed):
    gaps = trace(kind, PROF, 300, seed)
    np.testing.assert_array_equal(gaps, trace(kind, JPROF, 300, seed))
    got, want = tpolicy.make_policy(name, PROF), jpolicy.make_policy(name, JPROF)
    outs = [got.on_gap(float(g)) for g in gaps]
    assert [dataclasses.astuple(o) for o in outs] == \
        [dataclasses.astuple(want.on_gap(float(g))) for g in gaps]
    e_inf = PROF.p_active_w * PROF.t_inf_s * gaps.size
    total = PROF.e_cfg_j + e_inf + sum(o.energy_j for o in outs)
    assert close(total, twl.simulate(gaps, name, PROF).energy_j, 1e-9)
    assert got.tau is None


def test_busy_ledger_and_throttle_hooks():
    got = tpolicy.make_policy("idle_waiting", PROF)
    want = jpolicy.make_policy("idle_waiting", JPROF)
    for pol in (got, want):
        for kind, s in (("prefill", 0.01), ("decode", 0.002), ("decode", 0.003)):
            pol.on_busy(kind, s)
        pol.on_throttle(0.05)
    assert got.busy_s == want.busy_s == {"prefill": 0.01, "decode": 0.005, "slow_down": 0.05}
    with pytest.raises(NotImplementedError):
        tpolicy.DutyCyclePolicy(PROF).on_gap(1.0)


def test_make_policy_passes_the_device_on():
    assert tpolicy.make_policy("adaptive", PROF, device="cpu").device == torch.device("cpu")
    assert tpolicy.make_policy("on_off", PROF, device="cpu").name == "on_off"
    with pytest.raises(ValueError, match="unknown policy"):
        tpolicy.make_policy("bogus", PROF)


def run_streaming(pol, gaps):
    """Every gap's outcome and the τ each decision was made with."""
    out = []
    for g in gaps:
        tau = pol.tau
        out.append((tau, pol.on_gap(float(g))))
    return out


def test_streaming_tau_matches_the_reference(monkeypatch):
    """The acceptance run of ``tests/test_scheduler.py``: an irregular
    stream of 1200 gaps, refit every 150 over a window of 400, through both
    packages.

    Each of the reference's refits is repeated by the port's ``learn_tau``
    on the same window, weights and τ0: within 1e-3 relative wherever the
    reference's own fit is determined to that margin.  The first refit
    (150 gaps) is not: no gap of its window lies between 0.2498 and 4.04,
    the loss is flat there up to the few long gaps' idle term, and the
    reference's τ moves 0.4% when its gaps move by 1e-6 relative (Adam's
    step, lr 0.05 in log τ, outweighs the slope).  Such a refit must land in
    the same interval between the window's gaps, where every gap of the
    window is decided alike.  Over the whole run the two policies decide
    every gap that does not lie between their two thresholds (widened by
    1e-3) alike, and the port's items/J are within 10% of the offline
    ``learn_tau`` run's."""
    fits, real = [], jpolicy.learn_tau

    def recorded(gaps, p, **kw):
        fits.append((np.array(gaps), kw, real(gaps, p, **kw)))
        return fits[-1][2]

    monkeypatch.setattr(jpolicy, "learn_tau", recorded)
    gaps = twl.irregular_trace(PROF, n=1200, seed=3)
    kw = {"window": 400, "refit_every": 150, "refit_steps": 150}
    pol = tpolicy.StreamingTauPolicy(PROF, device="cpu", **kw)
    got = run_streaming(pol, gaps)
    want = run_streaming(jpolicy.StreamingTauPolicy(JPROF, **kw), gaps)
    assert pol.refits == len(fits) == 1200 // 150 and pol.seen == 1200

    ill_conditioned = 0
    for window, fit_kw, jtau in fits:
        tau = twl.learn_tau(window, PROF, device="cpu", **fit_kw)
        if close(tau, jtau, TAU_REL):
            continue
        shaken = real(window * (1 + 1e-6), JPROF, **fit_kw)
        assert not close(shaken, jtau, TAU_REL), (tau, jtau, shaken)
        lo, hi = sorted((tau, jtau))
        assert not ((window > lo) & (window <= hi)).any(), (tau, jtau)
        ill_conditioned += 1
    assert ill_conditioned <= 1

    for g, (tau, out), (jtau, jout) in zip(gaps, got, want):
        lo, hi = sorted((tau, jtau))
        if not lo * (1 - TAU_REL) <= g <= hi * (1 + TAU_REL):
            assert out.slept == jout.slept and out.wake_s == jout.wake_s
    online_e = PROF.e_cfg_j + PROF.p_active_w * PROF.t_inf_s * gaps.size + \
        sum(o.energy_j for _, o in got)
    offline = twl.simulate(gaps, "adaptive", PROF,
                           tau=twl.learn_tau(gaps, PROF, device="cpu"))
    assert gaps.size / online_e >= 0.9 * offline.items_per_joule


def test_streaming_tau_adapts_to_regime_change():
    """τ moves when the gap regime shifts across the break-even point."""
    tau_be = twl.break_even_tau(PROF)
    pol = tpolicy.StreamingTauPolicy(PROF, window=120, refit_every=60, refit_steps=120,
                                     device="cpu")
    assert pol.tau == tau_be
    rng = np.random.default_rng(0)
    for g in rng.uniform(0.05 * tau_be, 0.3 * tau_be, 120):
        pol.on_gap(float(g))
    tau_short = pol.tau
    for g in rng.uniform(5 * tau_be, 12 * tau_be, 240):
        pol.on_gap(float(g))
    assert pol.tau != tau_short and pol.refits == 6


# ---------------------------------------------------------------------------
# reload costs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("chips,weight_bytes", [(1, None), (4, None), (2, 3.5e9)])
def test_gpu_reload_costs_match_tpu_reload_costs(arch, chips, weight_bytes):
    """With the TPU chip's constants the port's arithmetic is the
    reference's, exactly."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    got = tengine.gpu_reload_costs(cfg, TPU_LIKE, chips=chips, weight_bytes=weight_bytes)
    assert got == jengine.tpu_reload_costs(jcfg, TPU, chips=chips, weight_bytes=weight_bytes)


def test_reload_costs_follow_parameter_count():
    """On the card's own constants the reload time and energy order the
    archs as their parameter counts do, and equal the chip's formula."""
    chip = tenergy.DEFAULT_CHIP
    cfgs = [get_config(a) for a in list_archs()]
    costs = [tengine.gpu_reload_costs(c) for c in cfgs]
    for cfg, (t, e) in zip(cfgs, costs):
        assert t == chip.reload_fixed_s + 2.0 * cfg.param_count() / chip.reload_bw
        assert e == t * chip.p_idle_w
    order = np.argsort([c.param_count() for c in cfgs], kind="stable")
    assert [costs[i] for i in order] == sorted(costs)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def stand_in(arch: str):
    """What the servers read of an engine when the latency is given."""
    return (types.SimpleNamespace(cfg=get_config(arch), device=torch.device("cpu")),
            types.SimpleNamespace(cfg=jget_config(arch)))


@pytest.mark.parametrize("strategy", ["on_off", "idle_waiting", "slow_down", "adaptive"])
@pytest.mark.parametrize("arch,chips", [("granite-3-8b", 1), ("whisper-tiny", 4)])
def test_server_stats_match_the_reference(strategy, arch, chips):
    teng, jeng = stand_in(arch)
    got = tengine.WorkloadAwareServer(teng, strategy=strategy, chip=TPU_LIKE, chips=chips)
    want = jengine.WorkloadAwareServer(jeng, strategy=strategy, chips=chips)
    assert (got.t_reload, got.e_reload) == (want.t_reload, want.e_reload)
    assert dataclasses.astuple(got.profile(0.02)) == dataclasses.astuple(want.profile(0.02))
    gaps = trace("bursty", got.profile(0.02), 400, 5)
    a, b = got.run_trace(gaps, t_inf=0.02), want.run_trace(gaps, t_inf=0.02)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.items_per_joule == b.items_per_joule
    assert got._measured_t is None


def test_learned_server_stats_match_the_reference():
    """``learn=True`` trains τ on the engine's device (the CPU here): its
    ledger within 1e-3 relative of the reference's, the same reloads."""
    teng, jeng = stand_in("granite-3-8b")
    got = tengine.WorkloadAwareServer(teng, chip=TPU_LIKE)
    want = jengine.WorkloadAwareServer(jeng)
    gaps = trace("bursty", got.profile(0.02), 300, 6)
    a = got.run_trace(gaps, t_inf=0.02, learn=True)
    b = want.run_trace(gaps, t_inf=0.02, learn=True)
    assert (a.items, a.reloads, a.missed, a.idle_s) == (b.items, b.reloads, b.missed, b.idle_s)
    assert close(a.energy_j, b.energy_j, TAU_REL) and a.busy_s == b.busy_s
    tau = twl.learn_tau(gaps, got.profile(0.02), device="cpu")
    assert a.reloads == int(np.count_nonzero(gaps > tau))


def test_compare_strategies_keeps_the_weight_bytes():
    """A server given measured weight bytes compares its strategies at those
    bytes' reload costs (the reference's ``compare_strategies`` drops them;
    without ``weight_bytes`` the two agree, above)."""
    teng, _ = stand_in("granite-3-8b")
    srv = tengine.WorkloadAwareServer(teng, weight_bytes=2.4e9)
    assert (srv.t_reload, srv.e_reload) == tengine.gpu_reload_costs(teng.cfg, weight_bytes=2.4e9)
    prof = srv.profile(0.3)
    gaps = trace("bursty", prof, 200, 7)
    res = srv.compare_strategies(gaps, t_inf=0.3)
    for name, stats in res.items():
        tau = twl.break_even_tau(prof) if name == "adaptive" else None
        assert stats.energy_j == twl.simulate(gaps, name, prof, tau=tau).energy_j


def test_server_stats_defaults():
    s = tengine.ServerStats()
    assert dataclasses.asdict(s) == dataclasses.asdict(jengine.ServerStats())
    assert s.items_per_joule == 0.0


@pytest.fixture(scope="module")
def granite():
    """A reduced granite-3-8b engine on the CPU."""
    return tengine.InferenceEngine(get_reduced_config("granite-3-8b"),
                                   sc=tengine.ServeConfig(max_batch=2, max_len=48),
                                   device="cpu")


def test_run_trace_is_one_simulate_and_compare_is_stateless(granite):
    srv = tengine.WorkloadAwareServer(granite, strategy="adaptive")
    prof = srv.profile(0.01)
    gaps = twl.bursty_trace(prof, n=500, seed=4)
    tau = twl.break_even_tau(prof)
    stats = srv.run_trace(gaps, t_inf=0.01)
    ref = twl.simulate(gaps, "adaptive", prof, tau=tau)
    assert (stats.energy_j, stats.items, stats.missed) == \
        (ref.energy_j, ref.items, ref.missed_deadlines)
    assert stats.reloads == int(np.count_nonzero(gaps > tau))
    res = srv.compare_strategies(gaps, t_inf=0.01)
    assert srv._measured_t is None  # no side channel
    assert set(res) == {"on_off", "idle_waiting", "slow_down", "adaptive"}
    again = srv.compare_strategies(gaps, t_inf=0.01)
    assert {k: v.energy_j for k, v in res.items()} == {k: v.energy_j for k, v in again.items()}


def test_strategy_choice_follows_gap_scale(granite):
    """The reference's ``test_strategy_choice_follows_gap_scale`` on the
    port's engine: the measured latency of a real ``generate`` on the CPU,
    short gaps (0.05 τ) and long (20 τ), the engine run during each trace."""
    srv = tengine.WorkloadAwareServer(granite, chips=1)
    t = srv.measure_latency(batch=2, new_tokens=2)
    assert t > 0 and srv._measured_t == t
    prof = srv.profile(t)
    assert prof.p_active_w == tenergy.DEFAULT_CHIP.p_peak_w
    tau = twl.break_even_tau(prof)
    short = twl.regular_trace(0.05 * tau + t, t, 40)
    long_ = twl.regular_trace(20 * tau + t, t, 40)
    res_s = srv.compare_strategies(short, batch=2, new_tokens=2, execute_every=40)
    res_l = srv.compare_strategies(long_, batch=2, new_tokens=2, execute_every=40)
    assert res_s["on_off"].items_per_joule <= res_s["idle_waiting"].items_per_joule
    assert res_l["idle_waiting"].items_per_joule <= res_l["on_off"].items_per_joule
    for res in (res_s, res_l):
        best = max(v.items_per_joule for v in res.values())
        assert res["adaptive"].items_per_joule >= 0.45 * best
    # the reference's system test: gaps of 30 τ, powering off beats idling
    gaps = twl.regular_trace(30 * tau + t, t, 30)
    res = srv.compare_strategies(gaps, batch=2, new_tokens=2, execute_every=30)
    assert res["on_off"].items_per_joule > res["idle_waiting"].items_per_joule


def test_learned_threshold_on_the_engine(granite):
    """``strategy="adaptive", learn=True`` trains τ on ``engine.device``."""
    srv = tengine.WorkloadAwareServer(granite, strategy="adaptive")
    prof = srv.profile(0.01)
    gaps = twl.irregular_trace(prof, n=400, seed=1)
    stats = srv.run_trace(gaps, t_inf=0.01, learn=True)
    tau = twl.learn_tau(gaps, prof, device=granite.device)
    assert stats.energy_j == twl.simulate(gaps, "adaptive", prof, tau=tau).energy_j
    assert stats.reloads == int(np.count_nonzero(gaps > tau))
