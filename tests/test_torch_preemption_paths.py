"""The port's scheduler on over-committed paged pools against the
reference's, on the CPU, on granite-3-8b (``tests/test_preemption.py``):
speculative runs restored by swap and by recompute, chunked admission, NaN
quarantine composed with preemption, speculative copy-on-write on a pool
too small for its worst case, the emergency path without a policy, SLO
tiers, deadlines with shedding, and a worst case the pool cannot hold.

Helpers and criterion are ``test_torch_preemption``'s (``assert_same`` of
``test_torch_scheduler``: tokens, flags and integer counters identical to
the reference's, floats within 1e-9 relative; every pool drained with its
refcounts conserved)."""
import numpy as np
import pytest

from test_torch_preemption import pair_of, press, run, stream
from test_torch_scheduler import JAX, PORT, streams, tokens

@pytest.mark.parametrize("swap", (True, False))
def test_speculative_pressure_identity_swap_and_recompute(swap):
    ref, tight = pair_of("granite-3-8b")
    reqs = stream(ref, seed=2, prompt_period=3)
    base = run(ref, reqs, speculate_k=3)
    rep = run(tight, reqs, speculate_k=3, preempt="tiered", swap=swap,
              make=lambda P: {"faults": press(P)})
    assert rep.failed == 0 and rep.preempted > 0
    assert tokens(rep) == tokens(base)
    if swap:
        assert rep.swapped > 0 and rep.swapped + rep.recomputed == rep.preempted
    else:
        assert rep.swapped == 0 and rep.recomputed == rep.preempted


def test_chunked_pressure_identity():
    ref, tight = pair_of("granite-3-8b")
    reqs = stream(ref, seed=4, prompt_lens=(6,), rate_hz=60.0)
    base = run(ref, reqs, prefill_chunk=2)
    rep = run(tight, reqs, prefill_chunk=2, preempt="tiered", make=lambda P: {"faults": press(P)})
    assert rep.failed == 0 and tokens(rep) == tokens(base)


def test_nan_quarantine_composes_with_preemption():
    ref, tight = pair_of("granite-3-8b")
    reqs = stream(ref, seed=5)
    base = run(ref, reqs)
    rep = run(tight, reqs, preempt="tiered", make=lambda P: {"faults": P.faults.FaultProfile(
        seed=9, nan_rate=0.15, press_rate=0.5, press_pages=2, max_faults=12)})
    assert rep.failed == 0 and tokens(rep) == tokens(base)
    assert rep.retried == sum(r.retries for r in rep.records)


def test_overcommitted_speculative_cow_never_raises_runtime_error():
    """Speculative verify tails and copy-on-write prefix pages on a pool too
    small for its worst case: ``PageExhausted`` leaves ``ensure_writable``
    before any replay, the scheduler preempts and retries the tick, and the
    engine's host check that no live page is written twice never fires."""
    ref, tight = pair_of("granite-3-8b", num_pages=7, share_prefix=True)
    prefix = np.random.default_rng(0).integers(0, ref[1].cfg.vocab_size, 4).astype(np.int32)
    reqs = stream(ref, n=6, seed=6, prompt_lens=(6,), rate_hz=80.0)
    for jr, tr in zip(*reqs):  # a shared 4-token prefix (one full block), random tails
        jr.prompt = tr.prompt = np.concatenate([prefix, tr.prompt[4:]])
    base = run(ref, reqs, prefill_chunk=2, speculate_k=3)
    rep = run(tight, reqs, prefill_chunk=2, speculate_k=3, preempt="tiered",
              make=lambda P: {"faults": press(P)})
    assert rep.failed == 0 and tokens(rep) == tokens(base)
    assert rep.preempted > 0 and rep.shared_hit_pages > 0


def test_emergency_path_keeps_tierless_runs_alive():
    ref, tight = pair_of("granite-3-8b")
    reqs = stream(ref, seed=7, rate_hz=80.0)
    base = run(ref, reqs)
    rep = run(tight, reqs, make=lambda P: {"faults": press(P)})  # preempt=None
    assert rep.failed == 0 and tokens(rep) == tokens(base)


def tier_lat(rep, reqs, tier, q=99):
    tiers = {r.rid: r.tier for r in reqs}
    lats = [r.latency_s for r in rep.records
            if tiers[r.rid] == tier and not r.shed and not r.failed]
    assert lats, f"no completed {tier}-tier requests"
    return float(np.percentile(lats, q))


def test_latency_tier_beats_tierless_and_batch_completes():
    ref, tight = pair_of("granite-3-8b", max_batch=2)
    reqs = stream(ref, n=10, seed=8, rate_hz=300.0, tier_mix=0.5)
    assert {r.tier for r in reqs[1]} == {"latency", "batch"}
    tiered = run(tight, reqs, preempt="tiered", make=lambda P: {"faults": press(P)})
    tierless = run(tight, reqs, make=lambda P: {"faults": press(P)})
    for rep in (tiered, tierless):
        assert rep.failed == 0 and rep.shed == 0 and len(tokens(rep)) == 10
    assert tier_lat(tiered, reqs[1], "latency") <= tier_lat(tierless, reqs[1], "latency")
    assert tokens(tiered) == tokens(tierless)


def test_preempt_and_shed_stay_deadline_correct():
    ref, tight = pair_of("granite-3-8b", max_batch=2)
    reqs = stream(ref, n=10, seed=9, rate_hz=300.0, tier_mix=0.5, deadline_s=0.12)
    rep = run(tight, reqs, preempt="tiered", shed=True, make=lambda P: {"faults": press(P)})
    assert rep.items + rep.shed + rep.failed == 10
    for r in rep.records:
        if r.shed or r.failed:
            assert np.isnan(r.finish_s)
        else:
            assert r.missed == (r.latency_s > 0.12)
    assert rep.missed == sum(r.missed for r in rep.records)


def test_paged_rejects_oversized_worst_case():
    _, tight = pair_of("granite-3-8b", num_pages=4, max_batch=2)
    reqs = streams("bursty_stream", 2, fast_rate_hz=100.0, slow_rate_hz=10.0, seed=0,
                   vocab_size=tight[1].cfg.vocab_size, prompt_lens=(9,), new_tokens=(8, 8))
    for P, eng, r in zip((JAX, PORT), tight, reqs):
        with pytest.raises(ValueError, match="pages"):
            P.sched.ContinuousBatchingScheduler(
                eng, policy="adaptive", calibration=P.sched.FixedCalibration(step_s=0.004)).run(r)
