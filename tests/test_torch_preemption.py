"""The port's scheduler on over-committed paged pools against the
reference's, on the CPU (``tests/test_preemption.py``): preempt-and-restore
identity in every family under seeded page pressure; the preemption
policy's orders, the constructor's check, the report's counters; and
``EngineCalibration`` on a paged engine, which must leave the scheduler's
pool alone.  ``test_torch_preemption_paths`` holds the restore paths and
tiers on granite-3-8b, ``test_torch_preemption_quant`` int8 pages.

Engines, streams, calibration and chip as in ``test_torch_scheduler``, and
its criterion (``assert_same``): per-request tokens, flags and every
integer counter of ``ServeReport`` (preempted, swapped, recomputed,
evictions, copy-on-write copies among them) identical to the reference's,
the floats within 1e-9 relative.  A run that hit the engine's host page
check ("a tick would write pages ...") would raise and fail; after every
run the pool is drained and its refcounts are conserved."""
import numpy as np
import pytest
import torch

from repro_torch.serving import scheduler as tsched

from test_torch_scheduler import (FAMILY_ARCHS, JAX, engines, run_both, streams, tokens,
                                  virtual_engines)

PAGED = {"max_batch": 3, "max_len": 32, "paged": True, "page_size": 4}


def press(P):
    """Every decode or verify tick pins 2 free pages out half the time."""
    return P.faults.FaultProfile(seed=3, press_rate=0.5, press_pages=2)


def pair_of(arch, num_pages=6, **kw):
    """(parity-sized pair, tight pair over-committed to ``num_pages``)."""
    sc = {**PAGED, **kw}
    return engines(arch, **sc), engines(arch, num_pages=num_pages, **sc)


def stream(pair, n=6, seed=1, new_tokens=(2, 8), prompt_lens=(4, 6), rate_hz=40.0, **kw):
    return streams("poisson_stream", n, rate_hz=rate_hz, seed=seed,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=prompt_lens,
                   new_tokens=new_tokens, **kw)


def drained(sched) -> None:
    pool = sched.pool
    assert pool.active_count == 0 and not pool.admitting.any() and not pool._press_pins
    pool.check_invariants()
    assert pool.pages.free_count == pool.num_pages - 1 - len(pool._prefix)


def run(pair, reqs, **kw):
    out = run_both(pair, reqs, policy="idle_waiting", **kw)
    drained(out[3])
    return out[1]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_pressure_run_token_identical_every_family(arch):
    ref, tight = pair_of(arch)
    reqs = stream(ref)
    base = run(ref, reqs)
    rep = run(tight, reqs, preempt="tiered", make=lambda P: {"faults": press(P)})
    assert rep.failed == 0 and rep.shed == 0 and rep.quarantined == 0
    assert all(r.retries == 0 for r in rep.records)
    assert tokens(rep) == tokens(base)
    assert rep.preempted > 0 and rep.preempt_wasted_j > 0
    assert rep.energy_j > base.energy_j


# ---------------------------------------------------------------------------
# the policy, the checks, the report, calibration on a paged engine
# ---------------------------------------------------------------------------
def test_preemption_policy_orders_match_the_reference():
    cands = [
        {"slot": 0, "tier": "latency", "slack": 0.1, "pages": 5, "progress": 0.9},
        {"slot": 1, "tier": "batch", "slack": 0.2, "pages": 2, "progress": 0.5},
        {"slot": 2, "tier": "batch", "slack": 9.0, "pages": 4, "progress": 0.1},
    ]
    first = {"tiered": 2, "footprint": 0, "slack": 2}
    for order in tsched.PreemptionPolicy.ORDERS:
        got = [c["slot"] for c in tsched.PreemptionPolicy(order).rank(cands)]
        assert got == [c["slot"] for c in JAX.sched.PreemptionPolicy(order).rank(cands)]
        assert got[0] == first[order]
    with pytest.raises(ValueError, match="preemption order"):
        tsched.PreemptionPolicy("bogus")
    pol = tsched.PreemptionPolicy("slack")
    assert tsched.make_preemption_policy(pol) is pol
    assert tsched.make_preemption_policy(None) is None
    assert tsched.make_preemption_policy("footprint").order == "footprint"


def test_preempt_requires_real_paged_pool():
    contiguous = virtual_engines("granite-3-8b", max_batch=2, max_len=32)[1]
    with pytest.raises(ValueError, match="paged"):
        tsched.ContinuousBatchingScheduler(contiguous, execute=False, preempt="tiered",
                                           calibration=tsched.FixedCalibration(step_s=0.004))


def test_summary_surfaces_preemption_counters():
    rep = tsched.ServeReport("continuous", [], 1.0, 1.0, 0, 0, preempted=3, swapped=2,
                             recomputed=1, preempt_wasted_j=0.5, evictions=4)
    s = rep.summary()
    assert "preempt=3" in s and "swap=2" in s and "recomp=1" in s and "evict=4" in s


@pytest.mark.parametrize("num_pages", (None, 6))
def test_engine_calibration_leaves_the_schedulers_pool_alone(num_pages):
    """``EngineCalibration`` on a paged CPU engine times its decode and
    verify ticks on full pools of its own (every slot at position 0, one
    fresh page each, no host page check tripped) and drops them with their
    graphs: the scheduler's pool keeps every page free, its table at
    scratch, and the engine holds graphs of no other pool."""
    _, eng = engines("granite-3-8b", max_batch=3, max_len=32, paged=True, page_size=4,
                     num_pages=num_pages)
    cal = tsched.EngineCalibration(eng, repeats=1)
    sched = tsched.ContinuousBatchingScheduler(eng, policy="idle_waiting", calibration=cal,
                                               speculate_k=3)
    assert cal._step is not None and cal._step > 0  # timed at construction
    assert cal.verify_s(3) > 0 and cal.prefill_s(1, 5) > 0 and cal.chunk_s(2, 4) > 0
    assert cal.verify_s(3) == cal._verify[3]  # memoized
    pool = sched.pool
    assert not pool.active.any() and (pool.table == 0).all()
    assert pool.pages.free_count == pool.num_pages - 1
    pool.check_invariants()
    assert list(eng._graphs.keys()) == []
    rep = sched.run(stream((None, eng), n=4)[1])
    assert rep.items == 4
    drained(sched)


def test_swap_image_is_a_copy_of_the_slot():
    """``swap_out``'s image holds copies of the slot's pages and unpaged rows
    (zamba2: K/V pages, conv and SSM state): the slot's next tenant
    overwrites the pool, not the image, and ``swap_in`` into another slot
    restores the bytes exactly, in place."""
    _, eng = engines("zamba2-7b", **PAGED)
    pool = eng.make_pool()
    cache_ids = {k: v.data_ptr() for k, v in pool.cache.items()}
    rng = np.random.default_rng(11)
    eng.prefill_into_slot(pool, 0, rng.integers(0, 512, 6).astype(np.int32), rid=0, budget=4)
    nb = pool._blocks_for(pool.slots[0].pos)
    ids = torch.as_tensor(pool.table[0, :nb].astype(np.int64))
    want = {k: (v.index_select(1, ids) if k in pool._pleaves else v[:, 0]).clone()
            for k, v in pool.cache.items()}
    image = pool.swap_out(0)
    eng.prefill_into_slot(pool, 0, rng.integers(0, 512, 7).astype(np.int32), rid=1, budget=4)
    pool.swap_in(1, image)
    ids = torch.as_tensor(pool.table[1, :nb].astype(np.int64))
    for k, v in pool.cache.items():
        got = v.index_select(1, ids) if k in pool._pleaves else v[:, 1]
        assert torch.equal(got, want[k]), k
    assert {k: v.data_ptr() for k, v in pool.cache.items()} == cache_ids
    pool.check_invariants()
