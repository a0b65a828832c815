"""The port's scheduler under a power envelope, a brownout governor and an
energy budget, against the reference's, on the CPU (engine-free runs):
``tests/test_brownout.py``'s scheduler tests (governed runs break no cap,
an ungoverned one is measured, ladder against uniform pacing, seeded
envelopes, the shed level, the hard energy budget and its idle floor) and
``tests/test_power.py``'s ``test_scheduler_clock_stretch``,
``test_therm_fault_creates_envelope_and_stretches`` and
``test_stall_tail_charged_at_idle_power``.  The reference's property test
over random envelopes is a seeded parametrised test here.  And the engine
now takes ``ServeConfig.energy_budget_j``, which the scheduler enforces.

Engines, streams, calibration and chip as in ``test_torch_scheduler``, and
its criterion (``assert_same``): per-request tokens, flags and every
integer counter of ``ServeReport`` (``cap_violation_ticks``,
``brownout_ticks``, ``brownout_transitions``, ``level_dwell``) identical to
the reference's, the floats (``peak_window_w``, ``peak_budget_window_j``,
``brownout_forgone_j`` among them) within 1e-9 relative."""
import math

import numpy as np
import pytest

from repro_torch.serving import brownout as tbrownout
from repro_torch.serving import engine as tengine
from repro_torch.serving import power as tpower
from repro_torch.serving import scheduler as tsched

from test_torch_scheduler import (CAL, TPU_LIKE, assert_same, run_both, streams,
                                  virtual_engines)


def virtual(reqs, make=None, sc=None, **kw):
    """``tests/test_brownout.py``'s ``_virtual``: whisper-tiny's reduced
    config on a virtual pool, fixed costs, idle-waiting."""
    pair = virtual_engines("whisper-tiny", **(sc or {"max_batch": 4, "max_len": 64}))
    return run_both(pair, reqs, policy="idle_waiting", execute=False, make=make, **kw)[1]


def busy_stream(n=24, seed=0, **kw):
    kw = {"rate_hz": 400.0, "prompt_lens": (4, 8), "new_tokens": (4, 16), **kw}
    return streams("poisson_stream", n, seed=seed, **kw)


def tight(P):
    return {"power": P.power.PowerEnvelope(caps=(P.power.CapWindow(0.0, 10.0, 100.0),))}


@pytest.mark.parametrize("gov", ("ladder", "uniform"))
def test_governed_run_zero_cap_violations(gov):
    rep = virtual(busy_stream(), make=tight, brownout=gov)
    assert rep.cap_violation_ticks == 0
    assert rep.brownout_ticks > 0 and rep.brownout_forgone_j > 0
    assert rep.peak_window_w <= 100.0 * (1 + 1e-9)
    assert "brownout" in rep.summary() and "capviol" in rep.summary()


def test_ignore_cap_counts_violations():
    rep = virtual(busy_stream(), make=tight)
    assert rep.cap_violation_ticks > 0 and rep.peak_window_w > 100.0
    assert rep.brownout_ticks == 0 and rep.brownout_forgone_j == 0.0


def test_ladder_run_cheaper_than_uniform_on_tiered_stream():
    reqs = busy_stream(seed=3)
    lad = virtual(reqs, make=tight, brownout="ladder")
    uni = virtual(reqs, make=tight, brownout="uniform")
    assert lad.cap_violation_ticks == uni.cap_violation_ticks == 0
    assert sum(lad.level_dwell[1:]) > 0
    assert uni.level_dwell[0] == sum(uni.level_dwell)
    assert {r.rid: r.tokens for r in lad.records} == {r.rid: r.tokens for r in uni.records}


# the reference's seeds 0-2, then the property test's random seeds drawn once
@pytest.mark.parametrize("seed", (0, 1, 2, *np.random.default_rng(2024).integers(0, 2**16, 5)))
def test_seeded_envelope_zero_violations(seed):
    """Caps drawn at the reference chip's peak (the port's default peak is
    the card's 700 W), so that both packages draw the same envelope."""
    seed = int(seed)
    n = 24 if seed < 3 else 12
    rep = virtual(busy_stream(n=n, seed=seed), brownout="ladder",
                  make=lambda P: {"power": P.power.PowerEnvelope.seeded(
                      seed, horizon_s=1.0, peak_w=TPU_LIKE.p_peak_w)})
    assert rep.cap_violation_ticks == 0


def test_shed_level_sheds_batch_but_not_latency_tier():
    reqs = busy_stream(n=12, seed=5, tier_mix=0.5)
    tiers = {r.rid: r.tier for r in reqs[1]}
    assert set(tiers.values()) == {"latency", "batch"}
    ctrls = {}

    def make(P):
        ctrl = ctrls[P.name] = P.brownout.BrownoutController()
        ctrl.level = P.brownout.LEVELS.index("shed")  # pinned: the crushing-cap endgame
        return {"brownout": ctrl,
                "power": P.power.PowerEnvelope(caps=(P.power.CapWindow(0.0, 1e9, 80.0),))}

    rep = virtual(reqs, make=make)
    # the 80 W cap never lets the ladder recover
    assert ctrls["port"].level == ctrls["jax"].level == tbrownout.LEVELS.index("shed")
    assert rep.shed == sum(v == "batch" for v in tiers.values())
    assert {r.rid for r in rep.records if not r.shed} == \
        {rid for rid, t in tiers.items() if t == "latency"}
    assert rep.cap_violation_ticks == 0


# ---------------------------------------------------------------------------
# the hard energy budget, which the engine now carries
# ---------------------------------------------------------------------------
def budget_sc(budget_j, window_s=0.25):
    return {"max_batch": 4, "max_len": 64, "energy_budget_j": budget_j,
            "budget_window_s": window_s}


@pytest.mark.parametrize("gov", (None, "ladder"))
def test_energy_budget_never_exceeded_in_any_window(gov):
    rep = virtual(busy_stream(), sc=budget_sc(40.0), brownout=gov)
    assert 0.0 < rep.peak_budget_window_j <= 40.0 * (1 + 1e-9)
    assert rep.cap_violation_ticks == 0


def test_budget_composes_with_envelope_caps():
    rep = virtual(busy_stream(), sc=budget_sc(40.0), make=tight, brownout="ladder")
    assert rep.peak_budget_window_j <= 40.0 * (1 + 1e-9)
    assert rep.peak_window_w <= 100.0 * (1 + 1e-9)
    assert rep.cap_violation_ticks == 0


def test_budget_below_idle_floor_rejected():
    # 75 W idle floor (TPU_LIKE) x 0.25 s window = 18.75 J: nothing fits under 10 J
    for sc, match in ((budget_sc(10.0), "idle floor"), (budget_sc(40.0, 0.0), "budget_window_s")):
        eng = virtual_engines("whisper-tiny", **sc)[1]
        with pytest.raises(ValueError, match=match):
            tsched.ContinuousBatchingScheduler(eng, execute=False, chip=TPU_LIKE,
                                               calibration=tsched.FixedCalibration(**CAL))
    # the card's own idle floor: 126.4 W x 0.25 s = 31.6 J
    eng = virtual_engines("whisper-tiny", **budget_sc(30.0))[1]
    with pytest.raises(ValueError, match="idle floor"):
        tsched.ContinuousBatchingScheduler(eng, execute=False,
                                           calibration=tsched.FixedCalibration(**CAL))


def test_engine_carries_the_budget_the_scheduler_enforces():
    """An engine built with ``ServeConfig.energy_budget_j`` constructs (it
    was once refused) and a scheduler over it holds every budget window
    to the budget, which the same stream breaks without it."""
    eng = tengine.InferenceEngine(virtual_engines()[1].cfg, params=False, device="cpu",
                                  sc=tengine.ServeConfig(**budget_sc(40.0)))
    assert eng.sc.energy_budget_j == 40.0
    reqs = busy_stream()[1]
    kw = dict(execute=False, chip=TPU_LIKE, calibration=tsched.FixedCalibration(**CAL),
              policy="idle_waiting")
    held = tsched.ContinuousBatchingScheduler(eng, **kw).run(reqs)
    assert 0.0 < held.peak_budget_window_j <= 40.0 * (1 + 1e-9)
    free = tsched.ContinuousBatchingScheduler(virtual_engines()[1], **kw).run(reqs)
    assert free.peak_budget_window_j == 0.0  # no budget, no ledger
    assert held.time_s > free.time_s and held.brownout_forgone_j > 0


# ---------------------------------------------------------------------------
# tests/test_power.py: clock stretch, thermal faults, the stall tail
# ---------------------------------------------------------------------------
def test_scheduler_clock_stretch():
    reqs = streams("poisson_stream", 8, seed=1, rate_hz=1e6, prompt_lens=(4, 8),
                   new_tokens=(4, 12))
    base = virtual(reqs)
    slow = virtual(reqs, make=lambda P: {"power": P.power.PowerEnvelope(
        events=(P.power.ThermalEvent(0.0, 0.5, math.inf),))})
    assert slow.time_s / base.time_s == pytest.approx(2.0, rel=0.01)
    assert {r.rid: r.tokens for r in slow.records} == {r.rid: r.tokens for r in base.records}
    assert slow.energy_j > base.energy_j


def test_therm_fault_creates_envelope_and_stretches():
    reqs = streams("poisson_stream", 10, seed=2, rate_hz=1e6, prompt_lens=(4, 8),
                   new_tokens=(8, 16))
    base = virtual(reqs)

    def make(P):
        return {"faults": P.faults.FaultProfile(seed=4, therm_rate=0.3, therm_frac=0.4,
                                                therm_ticks=32)}

    hot1, hot2 = virtual(reqs, make=make), virtual(reqs, make=make)
    assert_same(hot1, hot2, rel=0.0)
    assert hot1.time_s > base.time_s
    assert {r.rid: r.tokens for r in hot1.records} == {r.rid: r.tokens for r in base.records}


def test_stall_tail_charged_at_idle_power():
    chip, factor = TPU_LIKE, 4.0
    reqs = streams("poisson_stream", 1, seed=1, rate_hz=10.0, prompt_lens=(4, 4),
                   new_tokens=(4, 4))
    rep = virtual(reqs, sc={"max_batch": 1, "max_len": 64}, make=lambda P: {
        "faults": P.faults.FaultProfile(seed=0, stall_rate=1.0, stall_factor=factor)})
    rec = rep.records[0]
    cal = tsched.FixedCalibration(**CAL)
    tp, step = cal.prefill_s(1, rec.prompt_len), cal.step_s()
    want = (chip.step_power(1.0) * tp
            + 3 * (chip.step_power(1.0) * step + chip.p_idle_w * (factor - 1) * step))
    assert rec.energy_j == pytest.approx(want)
    assert rec.energy_j < chip.step_power(1.0) * tp + 3 * chip.step_power(1.0) * factor * step


def test_summary_surfaces_brownout_counters():
    rep = tsched.ServeReport("continuous", [], 1.0, 1.0, 0, 0, brownout_ticks=5,
                             cap_violation_ticks=2, brownout_forgone_j=0.25)
    s = rep.summary()
    assert "brownout=5" in s and "capviol=2" in s and "forgone=0.250J" in s


def test_envelope_objects_are_the_reference_semantics():
    """A cap and a thermal event read the same in both packages (the port's
    ``serving/power.py``, ported before the scheduler that reads it)."""
    from repro.serving import power as jpower

    env = tpower.PowerEnvelope(events=(tpower.ThermalEvent(0.0, 0.6, 0.1),),
                               caps=(tpower.CapWindow(0.01, 0.25, 100.0),))
    ref = jpower.PowerEnvelope(events=(jpower.ThermalEvent(0.0, 0.6, 0.1),),
                               caps=(jpower.CapWindow(0.01, 0.25, 100.0),))
    for t in np.linspace(0.0, 0.4, 41):
        assert env.clock_frac(float(t)) == ref.clock_frac(float(t))
        assert env.cap_w(float(t)) == ref.cap_w(float(t))
