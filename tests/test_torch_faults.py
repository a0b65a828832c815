"""The port's fault-handling host modules against the reference's:
``serving/faults.py`` (profiles, the spec parser, the seeded injector),
``serving/draft.py`` (the n-gram drafter and the speculation throttle) and
``core/retry.py`` (straggler detection, bounded-backoff restarts).  All of
them are host arithmetic on ``np.random.default_rng`` streams, so the same
seeds and observations must give the same draws, proposals, windows, delays
and flags in both packages.  Tolerance: none; every comparison is exact
equality."""
import dataclasses

import numpy as np
import pytest

from repro.core import retry as jretry
from repro.serving import draft as jdraft
from repro.serving import faults as jfaults
from repro_torch.core import retry as tretry
from repro_torch.serving import draft as tdraft
from repro_torch.serving import faults as tfaults


def fields(obj) -> dict:
    return dataclasses.asdict(obj)


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------
def test_named_profiles_match_the_reference():
    assert set(tfaults.FAULT_PROFILES) == set(jfaults.FAULT_PROFILES)
    for name, prof in tfaults.FAULT_PROFILES.items():
        assert fields(prof) == fields(jfaults.FAULT_PROFILES[name])
        assert prof.enabled == jfaults.FAULT_PROFILES[name].enabled


SPECS = ["none", "light", "heavy", "nan=0.1,stall=0.2,stallx=4,chunk=0.3,max=7",
         "press=0.2,pressn=3", "therm=0.25,thermf=0.6,thermt=24", "stall=0",
         "nan=0.05", "chunk=1.0,max=0"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 9])
def test_make_profile_matches_the_reference(spec, seed):
    got, want = tfaults.make_profile(spec, seed=seed), jfaults.make_profile(spec, seed=seed)
    assert (got is None) == (want is None)
    if got is not None:
        assert fields(got) == fields(want)
        # the parse round trip: every field keeps its type (ints stay ints)
        assert {k: type(v) for k, v in fields(got).items()} == \
            {k: type(v) for k, v in fields(want).items()}
        assert got.enabled


@pytest.mark.parametrize("spec", ["bogus=1", "nan", "thermz=1.0", "nan=0.1,,stall=1"])
def test_bad_specs_raise_in_both(spec):
    with pytest.raises(ValueError, match="bad fault spec"):
        tfaults.make_profile(spec)
    with pytest.raises(ValueError, match="bad fault spec"):
        jfaults.make_profile(spec)


AXES = ("poison", "stall", "press", "thermal", "chunk")


def drive_injector(mod, prof, ticks: int, rng_seed: int, axes=AXES):
    """A seeded tick sequence: each tick a random set of decoding slots and
    a random subset of the injector's calls on ``axes``, in the scheduler's
    order (the subset is drawn over all axes, whichever are driven)."""
    inj = mod.FaultInjector(mod.FaultProfile(**fields(prof)))
    order = np.random.default_rng(rng_seed)
    out = []
    for _ in range(ticks):
        slots = sorted(order.choice(8, size=int(order.integers(0, 5)), replace=False).tolist())
        skip = dict(zip(AXES, order.random(len(AXES)) < 0.2))
        row = []
        for axis in axes:
            if skip[axis]:
                continue
            if axis == "poison":
                row.append(("poison", tuple(inj.poison_victims(slots))))
            else:
                row.append((axis, getattr(inj, axis if axis != "chunk" else "chunk_fails")()))
        out.append(row)
    return out, inj.events


PROFILES = [
    tfaults.FaultProfile(seed=5, nan_rate=0.3, stall_rate=0.3, chunk_fault_rate=0.3,
                         max_faults=6),
    tfaults.FaultProfile(seed=11, nan_rate=0.1, stall_rate=0.2, stall_factor=4.0),
    tfaults.FaultProfile(seed=2, press_rate=0.4, press_pages=3, therm_rate=0.3,
                         therm_frac=0.6, therm_ticks=24),
    tfaults.FaultProfile(seed=3, nan_rate=0.05, stall_rate=0.05, chunk_fault_rate=0.25,
                         press_rate=0.1, therm_rate=0.1),
    tfaults.FaultProfile(seed=1),
]


@pytest.mark.parametrize("prof", PROFILES, ids=lambda p: f"seed{p.seed}")
@pytest.mark.parametrize("rng_seed", [0, 1])
def test_injector_draws_match_the_reference(prof, rng_seed):
    assert drive_injector(tfaults, prof, 120, rng_seed) == \
        drive_injector(jfaults, prof, 120, rng_seed)


@pytest.mark.parametrize("axis,rate", [("press", "press_rate"), ("thermal", "therm_rate")])
def test_disabled_axes_draw_nothing(axis, rate):
    """``press`` and ``therm`` consume draws only when enabled, so adding a
    call to them leaves the other axes' sequences as they were; enabled,
    they draw the same in both packages."""
    base = tfaults.FaultProfile(seed=11, nan_rate=0.3, stall_rate=0.3)
    with_axis, _ = drive_injector(tfaults, base, 60, 0, ("poison", axis, "stall"))
    without, _ = drive_injector(tfaults, base, 60, 0, ("poison", "stall"))
    strip = lambda rows: [[c for c in r if c[0] != axis] for r in rows]  # noqa: E731
    assert strip(with_axis) == without
    assert all(c[1] in (0, None) for r in with_axis for c in r if c[0] == axis)
    on = dataclasses.replace(base, **{rate: 0.5})
    assert drive_injector(tfaults, on, 60, 0, ("poison", axis, "stall")) == \
        drive_injector(jfaults, on, 60, 0, ("poison", axis, "stall"))


# ---------------------------------------------------------------------------
# draft
# ---------------------------------------------------------------------------
def drive_drafter(mod, k, ticks, seed, **kw):
    """Three requests over a small vocabulary (so n-grams recur), each tick
    a proposal and then 1-3 committed tokens; one request forgotten and
    begun again half way.  Returns every proposal."""
    rng = np.random.default_rng(seed)
    d = mod.NgramDrafter(k, **kw)
    for rid in range(3):
        d.begin(rid, rng.integers(0, 6, int(rng.integers(1, 12))))
    out = []
    for t in range(ticks):
        for rid in range(3):
            out.append(d.propose(rid).tolist())
            d.observe(rid, rng.integers(0, 6, int(rng.integers(1, 4))))
        if t == ticks // 2:
            d.forget(1)
            d.begin(1, rng.integers(0, 6, 5))
    out.append(d.propose(99).tolist())  # an unknown request: zeros
    return out


@pytest.mark.parametrize("k,kw", [(4, {}), (1, {}), (3, {"max_ngram": 2, "min_ngram": 2}),
                                  (4, {"max_history": 16}), (8, {"max_ngram": 6})])
@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_drafts_match_the_reference(k, kw, seed):
    got = drive_drafter(tdraft, k, 60, seed, **kw)
    assert got == drive_drafter(jdraft, k, 60, seed, **kw)
    assert all(len(p) == k for p in got)


def test_drafter_replays_a_period():
    """A periodic history drafts its continuation (the prompt-lookup case)."""
    d = tdraft.NgramDrafter(4)
    d.begin(0, [1, 2, 3, 1, 2, 3, 1])
    # [1, 2, 3, 1] recurs at the start; its continuation runs into the
    # history's end and is padded with its last token
    assert d.propose(0).tolist() == [2, 3, 1, 1]
    with pytest.raises(ValueError):
        tdraft.NgramDrafter(0)


def drive_throttle(mod, k_max, ticks, seed, **kw):
    """Two requests with acceptance rates that drift from good to bad and
    back; the window each tick and the drafts accepted of it."""
    rng = np.random.default_rng(seed)
    th = mod.SpecThrottle(k_max, **kw)
    th.begin(0)
    th.begin(1)
    out = []
    for t in range(ticks):
        p = 0.9 if (t // 20) % 2 == 0 else 0.05
        for rid in (0, 1):
            k = th.window(rid)
            acc = int(rng.binomial(k, p if rid == 0 else 1 - p)) if k else 0
            th.observe(rid, acc, k)
            out.append((k, acc))
    th.forget(0)
    out.append(th.window(0))
    return out


@pytest.mark.parametrize("k_max,kw", [(8, {}), (4, {"lo": 0.2, "hi": 0.5, "alpha": 0.5,
                                                    "probe_every": 3}),
                                      (1, {"probe_every": 2}), (16, {"lo": 0.0, "hi": 1.0})])
@pytest.mark.parametrize("seed", [0, 3])
def test_spec_throttle_windows_match_the_reference(k_max, kw, seed):
    assert drive_throttle(tdraft, k_max, 100, seed, **kw) == \
        drive_throttle(jdraft, k_max, 100, seed, **kw)


def test_spec_throttle_halved_and_argument_checks():
    for k in (1, 4, 8, 13):
        for steps in (-1, 0, 1, 2, 5):
            assert tdraft.SpecThrottle.halved(k, steps) == jdraft.SpecThrottle.halved(k, steps)
    for bad in ({"k_max": 0}, {"k_max": 4, "lo": 0.5, "hi": 0.5}):
        with pytest.raises(ValueError):
            tdraft.SpecThrottle(**bad)


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"max_restarts": 3, "backoff_s": 0.5, "backoff_factor": 3.0,
                                     "max_backoff_s": 4.0}])
def test_restart_delays_match_the_reference(kw):
    got, want = tretry.RestartPolicy(**kw), jretry.RestartPolicy(**kw)
    assert fields(got) == fields(want)
    assert [got.delay(a) for a in range(12)] == [want.delay(a) for a in range(12)]


@pytest.mark.parametrize("kw", [{}, {"patience": 1, "warmup": 2, "z_threshold": 3.0},
                                {"alpha": 0.3, "patience": 2, "warmup": 0}])
@pytest.mark.parametrize("seed", [0, 4])
def test_straggler_flags_match_the_reference(kw, seed):
    """Step times with a 0.15 rate of 25x stalls, a run of 6 stalls and one
    reset: the same flags, EMA state and streaks in both packages."""
    rng = np.random.default_rng(seed)
    times = 0.01 * (1 + 0.1 * rng.standard_normal(200))
    times[rng.random(200) < 0.15] *= 25.0
    times[150:156] = 0.25
    got, want = tretry.StragglerDetector(**kw), jretry.StragglerDetector(**kw)
    flags = []
    for i, t in enumerate(times):
        flags.append(got.observe(float(t)))
        assert flags[-1] == want.observe(float(t))
        if i == 100:
            got.reset()
            want.reset()
        assert fields(got) == fields(want)
    assert any(flags)


@pytest.mark.parametrize("fail_at,max_restarts", [((), 5), ((3, 7, 7), 5), ((2, 2, 2), 2)])
def test_run_with_restarts_matches_the_reference(fail_at, max_restarts):
    """The same failures (a step listed twice fails twice) give the same
    steps run, sleeps, restores and stats, or the same final raise."""

    def run(mod):
        log, pending = [], list(fail_at)

        def step(s):
            log.append(("step", s))
            if s in pending:
                pending.remove(s)
                raise mod.WorkerFailure(f"step {s}")

        def restore():
            log.append(("restore",))
            return max(0, log[-2][1] - 1) if log[-2][0] == "step" else 0

        try:
            stats = mod.run_with_restarts(step, start_step=0, num_steps=10, restore_fn=restore,
                                          policy=mod.RestartPolicy(max_restarts=max_restarts),
                                          sleep=lambda s: log.append(("sleep", s)))
        except mod.WorkerFailure as e:
            stats = {"raised": str(e)}
        return stats, log

    assert run(tretry) == run(jretry)
    assert issubclass(tretry.WorkerFailure, RuntimeError)
