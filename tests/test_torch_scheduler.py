"""The port's continuous-batching scheduler (``serving/scheduler.py``)
against the reference's, on the CPU: invariants, lockstep generate, chunked
identity and FIFO groups, deadlines and shedding, the virtual ledger, the
busy hook and ``run_static_batches``, over the five cache layouts of
``FAMILY_ARCHS``.

Every engine is a reduced config in f32 on the same weights in both
packages (``test_torch_paged_serving.weights``, carried with
``params_from_numpy``); every stream comes from both packages' ``load``
generators with one seed; every run has one ``FixedCalibration`` and the
port's scheduler runs at ``TPU_LIKE`` (``H100Chip`` with the reference
chip's duty-cycle constants), so that the same arithmetic gives the same
ledger.  The criterion (``assert_same``):

* per-request tokens, the shed / failed / missed flags, the retries and
  every integer counter of ``ServeReport`` identical;
* ``admit_s``, ``finish_s``, ``energy_j``, ``waste_j`` and the report's
  float fields within 1e-9 relative under the fixed policies (a sum in
  another order), and within 1e-3 relative where an adaptive policy has
  refit its τ (``torch.autograd`` here, ``jax.grad`` there: the rule of
  ``tests/test_torch_duty_cycle.py``).

The helpers here are shared by the other ``test_torch_scheduler_*`` and
``test_torch_preemption`` files."""
import dataclasses
import functools
import math
import types

import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.core import energy as jenergy
from repro.core import retry as jretry
from repro.serving import brownout as jbrownout
from repro.serving import engine as jengine
from repro.serving import faults as jfaults
from repro.serving import load as jload
from repro.serving import power as jpower
from repro.serving import scheduler as jsched
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.core import energy as tenergy
from repro_torch.core import retry as tretry
from repro_torch.serving import brownout as tbrownout
from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import load as tload
from repro_torch.serving import power as tpower
from repro_torch.serving import scheduler as tsched

from test_torch_paged_serving import weights

torch.set_num_threads(1)
FAMILY_ARCHS = ("granite-3-8b", "deepseek-v3-671b", "mamba2-780m", "zamba2-7b", "whisper-tiny")
REL, TAU_REL = 1e-9, 1e-3
# each package's modules under one set of names, for objects a run needs from
# its own package (fault profiles, envelopes, retry policies, detectors)
JAX = types.SimpleNamespace(name="jax", energy=jenergy, retry=jretry, brownout=jbrownout,
                            engine=jengine, faults=jfaults, load=jload, power=jpower,
                            sched=jsched)
PORT = types.SimpleNamespace(name="port", energy=tenergy, retry=tretry, brownout=tbrownout,
                             engine=tengine, faults=tfaults, load=tload, power=tpower,
                             sched=tsched)
TPU = jenergy.DEFAULT_CHIP
TPU_LIKE = dataclasses.replace(tenergy.DEFAULT_CHIP, p_idle_w=TPU.p_idle_w,
                               p_peak_w=TPU.p_peak_w, reload_bw=TPU.reload_bw,
                               reload_fixed_s=TPU.reload_fixed_s)
CAL = dict(step_s=0.004, prefill_base_s=0.001, prefill_per_tok_s=0.001, verify_per_tok_s=0.0001)


@functools.lru_cache(maxsize=None)
def engines(arch: str, quant: str | None = None, **sc) -> tuple:
    """(JAX engine, port engine on the CPU) over the same f32 weights, one
    ``ServeConfig(**sc)`` each; cached, so that the JAX engine's jitted
    steps compile once a file.  ``quant="int8"``: each engine quantizes
    the weights at init, to the same bytes (``test_torch_quant_serving``)."""
    jcfg, jp, tcfg, tp = weights(arch)
    jcfg, tcfg = (dataclasses.replace(c, quant=quant) for c in (jcfg, tcfg))
    return (jengine.InferenceEngine(jcfg, params=jp, sc=jengine.ServeConfig(**sc)),
            tengine.InferenceEngine(tcfg, params=tp, sc=tengine.ServeConfig(**sc), device="cpu"))


@functools.lru_cache(maxsize=None)
def virtual_engines(arch: str = "whisper-tiny", **sc) -> tuple:
    """Weightless engines for engine-free runs (``execute=False``): the
    scheduler reads their config and ``ServeConfig`` only."""
    sc = sc or {"max_batch": 4, "max_len": 64}
    return (jengine.InferenceEngine(jax_config(arch), params=False, sc=jengine.ServeConfig(**sc)),
            tengine.InferenceEngine(torch_config(arch), params=False,
                                    sc=tengine.ServeConfig(**sc), device="cpu"))


def streams(gen: str, n: int, **kw) -> tuple:
    """The same stream from both packages' ``load`` generator ``gen``."""
    out = (getattr(jload, gen)(n, **kw), getattr(tload, gen)(n, **kw))
    for a, b in zip(*out):
        assert (a.rid, a.arrival_s, a.new_tokens, a.deadline_s, a.tier) == \
            (b.rid, b.arrival_s, b.new_tokens, b.deadline_s, b.tier)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    return out


def run_both(pair, reqs, *, make=None, cal=CAL, **kw):
    """One run of each package's scheduler over ``pair`` (JAX engine, port
    engine) and ``reqs`` (the two streams): the same keyword arguments,
    ``make(P)`` adding the objects built from package ``P``'s own modules,
    one ``FixedCalibration(**cal)`` (``cal=None``: the engine's own), the
    port at ``TPU_LIKE``.  Returns (JAX report, port report, JAX
    scheduler, port scheduler), the reports held to each other."""
    out = []
    for P, eng, r in ((JAX, pair[0], reqs[0]), (PORT, pair[1], reqs[1])):
        k = dict(kw, **(make(P) if make else {}))
        if cal is not None:
            k["calibration"] = P.sched.FixedCalibration(**cal)
        if P is PORT:
            k["chip"] = TPU_LIKE
        s = P.sched.ContinuousBatchingScheduler(eng, **k)
        out.append((s.run(r), s))
    (jr, js), (tr, ts) = out
    assert_same(jr, tr, rel=TAU_REL if getattr(ts.policy, "refits", 0) else REL)
    return jr, tr, js, ts


def close(a: float, b: float, rel: float) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


def assert_same(jr, tr, rel: float = REL) -> None:
    """A JAX ``ServeReport`` and a port one: integers, flags and tokens
    equal, floats within ``rel`` (the module docstring's criterion)."""
    assert [f.name for f in dataclasses.fields(jr)] == [f.name for f in dataclasses.fields(tr)]
    for f in dataclasses.fields(jr):
        a, b = getattr(jr, f.name), getattr(tr, f.name)
        if f.name == "records":
            assert len(a) == len(b)
            for ra, rb in zip(a, b):
                for g in dataclasses.fields(ra):
                    x, y = getattr(ra, g.name), getattr(rb, g.name)
                    if isinstance(x, float):
                        assert close(x, y, rel), (ra.rid, g.name, x, y)
                    else:
                        assert x == y, (ra.rid, g.name, x, y)
        elif isinstance(a, float):
            assert close(a, b, rel), (f.name, a, b)
        else:
            assert a == b, (f.name, a, b)


def tokens(rep) -> dict:
    return {r.rid: r.tokens for r in rep.records if not r.shed and not r.failed}


FAMILY_SC = {"max_batch": 3, "max_len": 48}


# ---------------------------------------------------------------------------
# every family: invariants, chunked identity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_scheduler_invariants_every_family(arch):
    pair = engines(arch, **FAMILY_SC)
    vocab = pair[1].cfg.vocab_size
    reqs = streams("poisson_stream", 6, rate_hz=40.0, seed=1, vocab_size=vocab,
                   prompt_lens=(4, 6), new_tokens=(1, 4))
    _, rep, _, sched = run_both(pair, reqs, policy="adaptive")
    # no slot leaks: everything admitted finished and freed its slot
    assert sched.admitted == sched.completed == len(reqs[1])
    assert sched.pool.active_count == 0
    assert rep.items == len(reqs[1])
    by_rid = {rec.rid: rec for rec in rep.records}
    for r in reqs[1]:
        rec = by_rid[r.rid]
        assert len(rec.tokens) == r.new_tokens
        assert all(0 <= t < vocab for t in rec.tokens)
        assert rec.admit_s >= r.arrival_s
        assert rec.finish_s > rec.admit_s or r.new_tokens == 1
    assert rep.energy_j > 0 and rep.time_s > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_chunked_scheduler_token_identical_every_family(arch):
    """Chunked admission gives blocking admission's tokens, in both
    packages, and each run the reference's."""
    pair = engines(arch, **FAMILY_SC)
    reqs = streams("bursty_stream", 8, fast_rate_hz=2000.0, slow_rate_hz=20.0, seed=3,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(4, 9), new_tokens=(1, 4))
    _, block, _, _ = run_both(pair, reqs, policy="adaptive")
    _, chunk, _, sched = run_both(pair, reqs, policy="adaptive", prefill_chunk=4)
    assert chunk.mode == "chunked" and chunk.chunks > 0
    assert sched.admitted == sched.completed == len(reqs[1])
    assert sched.pool.active_count == 0 and not sched.pool.admitting.any()
    assert tokens(block) == tokens(chunk)


# ---------------------------------------------------------------------------
# one request: lockstep generate, partial and oversized chunks
# ---------------------------------------------------------------------------
def one_request(n: int, new_tokens: int, seed: int = 0, **kw) -> tuple:
    vocab = torch_config("granite-3-8b").vocab_size
    prompt = np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)
    return tuple([P.load.Request(rid=0, arrival_s=0.0, prompt=prompt, new_tokens=new_tokens,
                                 **kw)] for P in (JAX, PORT))


def test_scheduler_matches_lockstep_generate_greedy():
    """A request served alone through the slot pool reproduces the port's
    lockstep ``generate``, and the reference's run."""
    pair = engines("granite-3-8b", **FAMILY_SC)
    reqs = one_request(7, 6)
    _, rep, _, _ = run_both(pair, reqs, policy="idle_waiting")
    assert rep.records[0].tokens == pair[1].generate(reqs[1][0].prompt[None], 6)[0].tolist()


def test_chunked_partial_and_oversized_chunks():
    pair = engines("granite-3-8b", **FAMILY_SC)
    reqs = one_request(11, 5)
    _, ref, _, _ = run_both(pair, reqs, policy="idle_waiting")
    for chunk in (4, 32):
        _, rep, _, _ = run_both(pair, reqs, policy="idle_waiting", prefill_chunk=chunk)
        assert rep.records[0].tokens == ref.records[0].tokens
        assert rep.chunks == -(-11 // chunk)


# ---------------------------------------------------------------------------
# engine-free runs: groups, FIFO, the busy hook, deadlines
# ---------------------------------------------------------------------------
VCAL = dict(step_s=0.004, prefill_base_s=0.001, prefill_per_tok_s=5e-4)


def test_chunked_same_length_group_admission():
    """A burst of same-length arrivals admits as ONE group: ceil(s0 /
    chunk) chunk calls, identical admit times."""
    reqs = tuple([P.load.Request(rid=i, arrival_s=0.0, prompt=np.zeros(16, np.int32),
                                 new_tokens=4) for i in range(3)] for P in (JAX, PORT))
    _, rep, _, _ = run_both(virtual_engines(), reqs, cal=VCAL, policy="idle_waiting",
                            execute=False, prefill_chunk=8)
    assert rep.chunks == 2
    assert len({r.admit_s for r in rep.records}) == 1


@pytest.mark.parametrize("chunk", (None, 8))
def test_chunked_admission_fifo_across_bursts(chunk):
    reqs = streams("bursty_stream", 48, fast_rate_hz=400.0, slow_rate_hz=3.0, seed=7,
                   vocab_size=64, prompt_lens=(4, 8, 16), new_tokens=(2, 8))
    _, rep, _, _ = run_both(virtual_engines(), reqs, cal=VCAL, policy="adaptive",
                            execute=False, prefill_chunk=chunk)
    admits = [r.admit_s for r in sorted(rep.records, key=lambda r: r.rid)]
    assert all(a <= b for a, b in zip(admits, admits[1:]))


def test_policy_busy_hook_sees_mixed_ticks():
    pair = virtual_engines(max_batch=2, max_len=64)
    reqs = streams("poisson_stream", 10, rate_hz=50.0, seed=0, vocab_size=64,
                   prompt_lens=(8, 16), new_tokens=(2, 6))
    _, _, js, ts = run_both(pair, reqs, cal=VCAL, policy="adaptive", execute=False,
                            prefill_chunk=8)
    busy = ts.policy.busy_s
    assert busy["prefill"] > 0 and busy["decode"] > 0
    assert busy["prefill"] >= ts.chunks * ts.cal.prefill_s(1, 1)
    assert set(busy) == set(js.policy.busy_s)
    assert all(close(busy[k], js.policy.busy_s[k], REL) for k in busy)


def test_scheduler_queue_pressure_and_deadlines():
    """A burst far beyond the pool: requests queue, all complete, and the
    misses flow into the ``SimResult``."""
    pair = engines("granite-3-8b", max_batch=2, max_len=32)
    reqs = streams("bursty_stream", 10, fast_rate_hz=5000.0, slow_rate_hz=50.0, seed=0,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(4,), new_tokens=(2, 5),
                   deadline_s=1e-4)
    _, rep, _, sched = run_both(pair, reqs, policy="adaptive")
    assert rep.items == 10 and sched.pool.active_count == 0
    sim = rep.to_sim_result()
    assert sim.items == rep.items and sim.energy_j == rep.energy_j
    assert sim.missed_deadlines == sum(r.missed for r in rep.records) > 0


@pytest.mark.parametrize("shed", (False, True))
def test_deadline_exactly_at_completion_is_on_time(shed):
    """Power-of-two costs make the ledger exact: a request finishing on its
    deadline is on time, one ulp tighter is shed (or missed)."""
    cal = dict(step_s=2.0 ** -8, prefill_base_s=2.0 ** -10, prefill_per_tok_s=2.0 ** -10)
    s0, nt = 8, 4
    exact = tsched.FixedCalibration(**cal).prefill_s(1, s0) + (nt - 1) * cal["step_s"]

    def req(d):
        return tuple([P.load.Request(rid=0, arrival_s=0.0, prompt=np.zeros(s0, np.int32),
                                     new_tokens=nt, deadline_s=d)] for P in (JAX, PORT))

    _, rep, _, _ = run_both(virtual_engines(max_batch=2, max_len=64), req(exact), cal=cal,
                            policy="idle_waiting", execute=False, shed=shed)
    rec = rep.records[0]
    assert rec.latency_s == exact and not rec.missed and not rec.shed
    assert rep.missed == 0 and rep.shed == 0 and rep.items == 1
    _, tight, _, _ = run_both(virtual_engines(max_batch=2, max_len=64),
                              req(float(np.nextafter(exact, 0.0))), cal=cal,
                              policy="idle_waiting", execute=False, shed=shed)
    if shed:
        assert tight.shed == 1 and tight.items == 0
    else:
        assert tight.missed == 1 and tight.items == 1


def test_deadline_below_minimum_prefill_shed_vs_missed():
    cal = dict(step_s=0.004, prefill_base_s=0.001, prefill_per_tok_s=0.001)
    s0 = 8
    dl = 0.5 * tsched.FixedCalibration(**cal).prefill_s(1, s0)
    reqs = tuple([P.load.Request(rid=0, arrival_s=0.0, prompt=np.zeros(s0, np.int32),
                                 new_tokens=4, deadline_s=dl)] for P in (JAX, PORT))
    pair = virtual_engines(max_batch=2, max_len=64)
    _, shed, _, _ = run_both(pair, reqs, cal=cal, policy="idle_waiting", execute=False,
                             shed=True)
    assert shed.shed == 1 and shed.items == 0
    rec = shed.records[0]
    assert rec.shed and rec.tokens == [] and rec.energy_j == 0.0
    assert shed.wasted_energy_j == 0.0
    _, serve, _, _ = run_both(pair, reqs, cal=cal, policy="idle_waiting", execute=False,
                              shed=False)
    assert serve.shed == 0 and serve.missed == 1 and serve.items == 1
    assert len(serve.records[0].tokens) == 4
    assert serve.energy_j > shed.energy_j
    assert serve.wasted_energy_j == serve.records[0].energy_j


@pytest.mark.parametrize("mode", ({}, {"prefill_chunk": 8}, {"speculate_k": 4}),
                         ids=("blocking", "chunked", "speculative"))
def test_missed_accounting_consistent_across_modes(mode):
    pair = virtual_engines(max_batch=4, max_len=64, spec_slack=4)
    reqs = streams("bursty_stream", 24, fast_rate_hz=2000.0, slow_rate_hz=20.0, seed=5,
                   vocab_size=64, prompt_lens=(8, 16), new_tokens=(4, 12), deadline_s=0.05)
    _, rep, _, _ = run_both(pair, reqs, cal=VCAL, policy="adaptive", execute=False, **mode)
    assert rep.items == 24 and rep.shed == 0 and rep.failed == 0
    assert rep.missed == sum(r.missed for r in rep.records) > 0
    for r in rep.records:
        assert r.missed == (r.latency_s > 0.05)


def test_virtual_scheduler_deterministic_and_continuous_wins():
    """Deterministic ledger, and continuous batching beats static batches
    on items/J and p50 on a bursty stream, in both packages alike."""
    pair = virtual_engines()
    cal = dict(step_s=0.004, prefill_base_s=0.003, prefill_per_tok_s=2e-4)
    service = 0.003 + 12 * 0.004
    reqs = streams("bursty_stream", 60, fast_rate_hz=2.0 / service,
                   slow_rate_hz=0.02 / service, seed=2, vocab_size=pair[1].cfg.vocab_size,
                   prompt_lens=(4, 8), new_tokens=(4, 24))
    _, a, _, _ = run_both(pair, reqs, cal=cal, policy="adaptive", execute=False)
    _, b, _, _ = run_both(pair, reqs, cal=cal, policy="adaptive", execute=False)
    assert a.energy_j == b.energy_j and a.p50_s == b.p50_s
    stats = [P.sched.run_static_batches(
        eng, r, policy="adaptive", execute=False, calibration=P.sched.FixedCalibration(**cal),
        flush_s=16 * service, **({"chip": TPU_LIKE} if P is PORT else {}))
        for P, eng, r in zip((JAX, PORT), pair, reqs)]
    assert_same(*stats)
    stat = stats[1]
    assert stat.items == a.items == 60
    assert a.items_per_joule > stat.items_per_joule
    assert a.p50_s < stat.p50_s


# ---------------------------------------------------------------------------
# run_static_batches executed, the profile, the report surface
# ---------------------------------------------------------------------------
def test_static_batches_execute_the_ports_generate():
    """Executed static batches: every cohort through the port's
    ``generate``, padded to its longest prompt, the reference's ledger and
    tokens."""
    pair = engines("granite-3-8b", max_batch=2, max_len=32)
    reqs = streams("poisson_stream", 5, rate_hz=40.0, seed=2,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(4, 6), new_tokens=(2, 5))
    reps = [P.sched.run_static_batches(
        eng, r, policy="idle_waiting", calibration=P.sched.FixedCalibration(**CAL),
        flush_s=0.05, **({"chip": TPU_LIKE} if P is PORT else {}))
        for P, eng, r in zip((JAX, PORT), pair, reqs)]
    assert_same(*reps)
    rep = reps[1]
    assert rep.mode == "static" and rep.items == 5
    assert all(len(rec.tokens) == rec.new_tokens for rec in rep.records)


@pytest.mark.parametrize("arch", ("granite-3-8b", "deepseek-v3-671b", "whisper-tiny"))
def test_gpu_profile_is_the_reference_profile_at_tpu_like(arch):
    want = jsched._tpu_profile(0.004, TPU, 2, jax_config(arch))
    got = tsched._gpu_profile(0.004, TPU_LIKE, 2, torch_config(arch))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_default_chip_is_the_card():
    pair = virtual_engines()
    sched = tsched.ContinuousBatchingScheduler(
        pair[1], execute=False, calibration=tsched.FixedCalibration(**VCAL),
        policy="idle_waiting")
    assert sched.chip is tenergy.DEFAULT_CHIP and isinstance(sched.chip, tenergy.H100Chip)
    assert sched.profile.p_active_w == tenergy.DEFAULT_CHIP.p_peak_w


def test_report_properties_and_summary_match_the_reference():
    rec = dict(rid=0, arrival_s=0.0, prompt_len=4, new_tokens=3, admit_s=0.01,
               finish_s=0.05, tokens=[1, 2, 3], energy_j=2.0)
    fields = dict(chunks=2, verify_ticks=3, accepted_tokens=7, shed=1, quarantined=1,
                  retried=1, failed=0, stragglers=2, degraded=1, throttled_ticks=4,
                  wasted_energy_j=0.5, preempted=3, swapped=2, recomputed=1,
                  preempt_wasted_j=0.25, evictions=4, brownout_ticks=5,
                  cap_violation_ticks=2, brownout_forgone_j=0.25)
    reps = []
    for P in (JAX, PORT):
        recs = [P.sched.RequestRecord(**rec), P.sched.RequestRecord(**dict(rec, rid=1,
                                                                         finish_s=0.2))]
        reps.append(P.sched.ServeReport("continuous", recs, 4.0, 0.2, 1, 0, **fields))
    j, t = reps
    assert t.summary() == j.summary()
    for name in ("items", "useful_items", "accepted_per_tick", "items_per_joule",
                 "goodput_per_joule", "p50_s", "p99_s"):
        assert getattr(t, name) == getattr(j, name), name
    assert dataclasses.astuple(t.to_sim_result()) == dataclasses.astuple(j.to_sim_result())


def test_constructor_checks_match_the_reference():
    pair = virtual_engines()
    for kw, match in (({"prefill_chunk": 0}, "prefill_chunk"),
                      ({"speculate_k": 0}, "speculate_k"),
                      ({"queue_limit": 0}, "queue_limit"),
                      ({"spec_throttle": True}, "spec_throttle")):
        for P, eng in zip((JAX, PORT), pair):
            with pytest.raises(ValueError, match=match):
                P.sched.ContinuousBatchingScheduler(
                    eng, execute=False, calibration=P.sched.FixedCalibration(**VCAL), **kw)
    with pytest.raises(ValueError, match="explicit calibration"):
        tsched.ContinuousBatchingScheduler(pair[1], execute=False)
    with pytest.raises(ValueError, match="explicit calibration"):
        tsched.run_static_batches(pair[1], [], execute=False)
