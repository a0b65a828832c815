"""The port's scheduler over paged pools against the reference's, on the
CPU: ``tests/test_paged_serving.py``'s scheduler tests.  Paged serving gives
contiguous serving's tokens in every family and under seeded NaN faults;
a shared prefix gives the same tokens in fewer chunk steps; a pool of two
contiguous slots' bytes holds more requests at once.  Chunked admission and
speculative verify on paged pools are ``test_torch_scheduler_paged_modes``'s.

Engines, streams, calibration and chip as in ``test_torch_scheduler``, and
its criterion (``assert_same``): per-request tokens, flags and every
integer counter of ``ServeReport`` (shared page hits, copy-on-write copies,
peak occupancy among them) identical to the reference's, the floats within
1e-9 relative; every paged pool is drained with its refcounts conserved."""
import pytest

from repro_torch.serving.kv_cache import cache_bytes, paged_cache_bytes

from test_torch_preemption import drained
from test_torch_scheduler import FAMILY_ARCHS, engines, run_both, streams, tokens


def pairs(arch, max_batch=2, max_len=32, slack=0, **paged_kw):
    """(contiguous pair, paged pair) over the same weights."""
    return (engines(arch, max_batch=max_batch, max_len=max_len, spec_slack=slack),
            engines(arch, max_batch=max_batch, max_len=max_len, paged=True, page_size=4,
                    **paged_kw))


def bursty(pair, n=6, seed=3, new_tokens=(1, 6)):
    return streams("bursty_stream", n, fast_rate_hz=2000.0, slow_rate_hz=20.0, seed=seed,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(4, 9), new_tokens=new_tokens)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_paged_token_identical_every_family(arch):
    contig, paged = pairs(arch)
    reqs = bursty(contig)
    _, base, _, _ = run_both(contig, reqs, policy="adaptive")
    _, rep, _, sched = run_both(paged, reqs, policy="adaptive")
    assert tokens(base) == tokens(rep)
    drained(sched)


@pytest.mark.parametrize("speculate_k", (None, 3))
def test_paged_fault_quarantine_identical(speculate_k):
    """Poison, quarantine, scrub and retry on the paged pool give the
    contiguous pool's tokens: no NaN of a poisoned slot's pages reaches a
    healthy slot's gather."""
    contig, paged = pairs("granite-3-8b", max_batch=3, max_len=48, slack=4)
    reqs = bursty(contig, n=8, new_tokens=(2, 6))

    def make(P):
        return {"faults": P.faults.FaultProfile(seed=7, nan_rate=0.08, stall_rate=0.1,
                                                stall_factor=3.0, chunk_fault_rate=0.2)}

    _, base, _, _ = run_both(contig, reqs, policy="adaptive", speculate_k=speculate_k,
                             make=make)
    _, rep, _, sched = run_both(paged, reqs, policy="adaptive", speculate_k=speculate_k,
                                make=make)
    assert base.quarantined == rep.quarantined > 0
    assert base.failed == rep.failed == 0
    assert tokens(base) == tokens(rep)
    drained(sched)


def test_shared_prefix_same_tokens_less_work():
    contig, paged = pairs("granite-3-8b", max_batch=4, share_prefix=True)
    reqs = streams("shared_prefix_stream", 6, rate_hz=30.0, prefix_len=8, tail_len=4,
                   warm_s=1.0, seed=0, vocab_size=contig[1].cfg.vocab_size, new_tokens=(2, 5))
    _, base, _, _ = run_both(contig, reqs, policy="adaptive", prefill_chunk=4)
    _, rep, _, sched = run_both(paged, reqs, policy="adaptive", prefill_chunk=4)
    assert tokens(base) == tokens(rep)
    assert rep.shared_hit_pages > 0 and rep.chunks < base.chunks
    assert rep.cow_copies == 0
    drained(sched)
    assert len(sched.pool._prefix) > 0


def test_paged_pool_packs_more_requests_than_contiguous_bytes():
    """Two contiguous slots' bytes re-spent on pages: a pool of 8 slots and
    15 pages serves a burst with more than two requests in flight."""
    contig, _ = pairs("granite-3-8b")
    cfg = contig[1].cfg
    paged8 = engines("granite-3-8b", max_batch=8, max_len=32, paged=True, page_size=4,
                     num_pages=15)
    pool = paged8[1].make_pool()
    assert paged_cache_bytes(cfg, batch=8, num_pages=15, page_size=4,
                             max_blocks=pool.max_blocks) <= cache_bytes(cfg, batch=2, max_len=32)
    reqs = streams("bursty_stream", 8, fast_rate_hz=5000.0, slow_rate_hz=50.0, seed=0,
                   vocab_size=cfg.vocab_size, prompt_lens=(4,), new_tokens=(4, 4))
    _, base, _, _ = run_both(contig, reqs, policy="adaptive")
    _, rep, _, sched = run_both(paged8, reqs, policy="adaptive")
    assert tokens(base) == tokens(rep)
    assert rep.peak_active > base.peak_active == 2
    drained(sched)
