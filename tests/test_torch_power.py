"""The port's power envelope and brownout governor against the reference's:
``serving/power.py`` (thermal events, cap windows, ``PowerEnvelope`` with
its seeded scenarios, the rolling compliance ledger) and
``serving/brownout.py`` (the hysteretic ladder and its knobs, the uniform
throttle, ``make_governor``).  Host arithmetic only, so the same inputs give
the same floats: every comparison between the packages is exact
equality.  The enforcement loop also holds the ledger's own guarantee (no
feasible tick ends over the cap, within ``violates``' 1e-9 relative slack).
The reference checks its ledger and its ladder with hypothesis; here a
seeded numpy sweep drives both packages."""
import math

import numpy as np
import pytest

from repro.core.energy import DEFAULT_CHIP as TPU
from repro.serving import brownout as jbrown
from repro.serving import power as jpower
from repro_torch.core.energy import DEFAULT_CHIP as H100
from repro_torch.serving import brownout as tbrown
from repro_torch.serving import power as tpower


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------
def test_constants_match_the_reference():
    assert tpower.MIN_CLOCK_FRAC == jpower.MIN_CLOCK_FRAC
    assert tbrown.LEVELS == jbrown.LEVELS and tbrown.GOVERNORS == jbrown.GOVERNORS


def sample_times(horizon: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.1 * horizon, 1.1 * horizon, 300),
                           np.linspace(0.0, horizon, 41)])


def envelope_trace(mod, env, times):
    return [(env.clock_frac(float(t)), env.cap_w(float(t))) for t in times]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("horizon", [1.0, 30.0])
def test_seeded_envelope_matches_the_reference(seed, horizon):
    """``PowerEnvelope.seeded`` with ``peak_w`` given: the same events, caps
    and clock fractions at sampled times in both packages."""
    kw = {"peak_w": 300.0, "n_therm": 2 + seed, "window_s": 0.1 * (seed + 1)}
    got = tpower.PowerEnvelope.seeded(seed, horizon, **kw)
    want = jpower.PowerEnvelope.seeded(seed, horizon, **kw)
    assert [(e.start_s, e.frac, e.recover_s) for e in got.scripted] == \
        [(e.start_s, e.frac, e.recover_s) for e in want.scripted]
    assert [(c.start_s, c.end_s, c.cap_w) for c in got.caps] == \
        [(c.start_s, c.end_s, c.cap_w) for c in want.caps]
    assert got.window_s == want.window_s and got.has_caps == want.has_caps
    times = sample_times(horizon, seed)
    assert envelope_trace(tpower, got, times) == envelope_trace(jpower, want, times)


def test_seeded_default_peak_is_the_cards():
    """Without ``peak_w`` the cap is drawn against the default chip's peak:
    the card's 700 W power limit in the port, the TPU's in the reference.
    Scaled by the two peaks, the draws are the same."""
    got = tpower.PowerEnvelope.seeded(4, 10.0)
    want = jpower.PowerEnvelope.seeded(4, 10.0)
    assert H100.p_peak_w == 700.0
    assert got.caps[0].cap_w / H100.p_peak_w == pytest.approx(
        want.caps[0].cap_w / TPU.p_peak_w, rel=1e-15)
    assert got.caps[0].cap_w == tpower.PowerEnvelope.seeded(4, 10.0, peak_w=700.0).caps[0].cap_w


@pytest.mark.parametrize("seed", [0, 5])
def test_dynamic_throttles_and_reset_match_the_reference(seed):
    """Scripted events and caps, then dynamic throttles (fractions below the
    floor and above 1 included), then ``reset``: the same clock fractions
    and caps at every sampled time."""
    rng = np.random.default_rng(seed)
    events = tuple((float(rng.uniform(0, 5)), float(rng.uniform(0.2, 1.0)),
                    float(rng.choice([rng.uniform(0.1, 3), math.inf]))) for _ in range(3))
    caps = tuple((float(a), float(a + rng.uniform(0.5, 3)), float(rng.uniform(50, 400)))
                 for a in rng.uniform(0, 5, 3))
    throttles = [(float(rng.uniform(0, 5)), float(f), float(rng.uniform(-1, 2)))
                 for f in (0.0, 0.01, 0.5, 1.5)]

    def build(mod):
        return mod.PowerEnvelope(tuple(mod.ThermalEvent(*e) for e in events),
                                 tuple(mod.CapWindow(*c) for c in caps), window_s=0.5)

    times = sample_times(6.0, seed)
    got, want = build(tpower), build(jpower)
    trace = []
    for mod, env in ((tpower, got), (jpower, want)):
        before = envelope_trace(mod, env, times)
        for th in throttles:
            env.throttle(*th)
        during = envelope_trace(mod, env, times)
        env.reset()
        trace.append((before, during, envelope_trace(mod, env, times)))
    assert trace[0] == trace[1]
    assert trace[0][0] == trace[0][2]          # reset drops only the dynamic events
    assert min(f for f, _ in trace[0][1]) >= tpower.MIN_CLOCK_FRAC


@pytest.mark.parametrize("bad", [{"window_s": 0.0}, {"caps": ((0.0, 1.0, 0.0),)},
                                 {"caps": ((2.0, 1.0, 10.0),)}])
def test_envelope_argument_checks(bad):
    for mod in (tpower, jpower):
        kw = dict(bad)
        if "caps" in kw:
            kw["caps"] = tuple(mod.CapWindow(*c) for c in kw["caps"])
        with pytest.raises(ValueError):
            mod.PowerEnvelope(**kw)


# ---------------------------------------------------------------------------
# rolling ledger
# ---------------------------------------------------------------------------
def drive_ledger(mod, seed: int) -> list:
    """The reference's enforcement loop (``test_ledger_idle_needed_property``)
    on one seed: before each busy tick insert the idle the ledger asks for,
    then record the tick; log every number the ledger gives."""
    rng = np.random.default_rng(seed)
    cap = float(rng.uniform(90.0, 190.0))
    led = mod.RollingLedger(float(rng.uniform(0.2, 1.5)), cap_w=cap, floor_w=75.0)
    t, log = 0.0, []
    for _ in range(30):
        dur = float(rng.uniform(0.01, 0.4))
        busy = float(rng.uniform(75.0, 300.0))
        s = led.idle_needed(t, dur, busy)
        if s > 0:
            led.add(t, t + s, 75.0)
            t += s
        led.add(t, t + dur, busy)
        t += dur
        log.append((s, led.window_j(t), led.window_w(t), led.mean_w(t), led.violates(t),
                    led.violates(t, cap_w=2 * cap), led.peak_window_j, led.peak_window_w,
                    len(led.segs)))
        feasible = (busy - 75.0) * min(dur, led.window_s) <= (cap - 75.0) * led.window_s
        assert not (feasible and led.violates(t)), (seed, t)
    return log


@pytest.mark.parametrize("seed", range(12))
def test_ledger_enforcement_matches_the_reference(seed):
    assert drive_ledger(tpower, seed) == drive_ledger(jpower, seed)


def test_ledger_window_accounting_matches_the_reference():
    out = []
    for mod in (tpower, jpower):
        led = mod.RollingLedger(1.0, floor_w=75.0)
        row = []
        for seg in ((0.0, 0.5, 200.0), (0.5, 0.5, 900.0), (0.5, 1.0, 75.0), (1.0, 2.0, 75.0)):
            led.add(*seg)
            row.append((led.window_j(seg[1]), led.mean_w(seg[1]), led.violates(seg[1], 130.0),
                        led.violates(seg[1]), led.idle_needed(seg[1], 0.3, 200.0, 130.0),
                        led.idle_needed(seg[1], 0.0, 200.0, 130.0)))
        out.append(row)
        with pytest.raises(ValueError):
            mod.RollingLedger(0.0)
    assert out[0] == out[1]
    assert out[0][0][0] == pytest.approx(75.0 + 0.5 * 125.0)


# ---------------------------------------------------------------------------
# brownout
# ---------------------------------------------------------------------------
def drive_governor(ctrl, seed: int, updates: int = 150) -> list:
    """Seeded spans of random draw, one control update after each against a
    cap that is lifted now and then; log the move, the level and every knob
    the scheduler reads."""
    rng = np.random.default_rng(seed)
    cap = float(rng.uniform(90.0, 180.0))
    t, log = 0.0, []
    for _ in range(updates):
        dt = float(rng.uniform(0.01, 0.1))
        w = float(rng.uniform(60.0, 320.0))
        ctrl.observe(t, t + dt, w * dt)
        t += dt
        live = cap if rng.random() < 0.9 else math.inf
        d = ctrl.update(t, live)
        log.append((d, ctrl.level, ctrl.power_w(t), ctrl.spec_cap(4), ctrl.spec_cap(1),
                    ctrl.chunk_ok(), ctrl.pace_idle(dt, w, live), ctrl.defer_batch(),
                    ctrl.take_preempt(), ctrl.shed_batch(), ctrl.transitions,
                    ctrl.brownout_ticks))
    log.append(list(ctrl.dwell))
    return log


GOVERNOR_KW = [{}, {"dwell_ticks": 1}, {"dwell_ticks": 3, "hi": 0.8, "lo": 0.5},
               {"window_s": 1.0, "dwell_ticks": 7}]


@pytest.mark.parametrize("kw", GOVERNOR_KW, ids=lambda kw: ",".join(map(str, kw.values())) or
                         "defaults")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_matches_the_reference(kw, seed):
    got = drive_governor(tbrown.BrownoutController(**kw), seed)
    assert got == drive_governor(jbrown.BrownoutController(**kw), seed)
    # the ladder's own contract: moves of one level, no move within the dwell
    levels = [0] + [row[1] for row in got[:-1]]
    moves = [i for i, (a, b) in enumerate(zip(levels, levels[1:])) if a != b]
    assert all(abs(levels[i + 1] - levels[i]) == 1 for i in moves)
    dwell = tbrown.BrownoutController(**kw).dwell_ticks
    assert all(b - a >= dwell for a, b in zip(moves, moves[1:]))


@pytest.mark.parametrize("seed", [0, 1])
def test_uniform_throttle_matches_the_reference(seed):
    got = drive_governor(tbrown.UniformThrottle(), seed)
    assert got == drive_governor(jbrown.UniformThrottle(), seed)
    assert {row[0] for row in got[:-1]} == {0} and {row[1] for row in got[:-1]} == {0}


def test_ladder_hysteresis_holds_a_level_in_both():
    """Between lo and hi of the cap nothing moves, even after the dwell."""
    out = []
    for mod in (tbrown, jbrown):
        ctrl, t, levels = mod.BrownoutController(dwell_ticks=1), 0.0, []
        for w in [300.0] * 3 + [80.0] * 40:
            ctrl.observe(t, t + 0.05, w * 0.05)
            t += 0.05
            ctrl.update(t, 100.0)
            levels.append(ctrl.level)
        out.append(levels)
    assert out[0] == out[1]
    assert len(set(out[0][13:])) == 1 and out[0][-1] > 0


def test_make_governor_matches_the_reference():
    for spec in (None, "off", "ladder", "uniform"):
        got, want = tbrown.make_governor(spec), jbrown.make_governor(spec)
        assert type(got).__name__ == type(want).__name__
    mine = tbrown.BrownoutController(dwell_ticks=3)
    assert tbrown.make_governor(mine) is mine
    with pytest.raises(ValueError, match="governor"):
        tbrown.make_governor("bogus")
    for bad in ({"lo": 0.9, "hi": 0.8}, {"dwell_ticks": 0}):
        with pytest.raises(ValueError):
            tbrown.BrownoutController(**bad)
