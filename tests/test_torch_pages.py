"""The port's paged KV-cache allocator (``repro_torch.serving.pages``) on the
CPU: the properties of ``tests/test_pages.py`` held by the port's pool
(refcount conservation, copy-on-write never writing a shared page, the
prefix registry's LRU, NaN taint and scrub, typed exhaustion with a clean
unwind, swap out / in bit for bit, page-pressure pins, byte accounting),
then the port against the JAX package: one seeded script of pool
operations gives the same tables, refcounts, free lists, registry,
counters and page bytes, exactly; ``quantize_kv`` / ``dequantize_kv`` give
the JAX package's bytes on rows that hold half-way ties, a NaN and an
infinity.  Runs under hypothesis where it is installed, else over seeded
interleavings."""
import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.serving import kv_cache as jax_kv
from repro.serving.pages import PagedSlotPool as JaxPagedSlotPool
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.serving.kv_cache import (cache_defs, dequantize_kv, page_defs,
                                          paged_cache_bytes, paged_keys, quantize_kv)
from repro_torch.serving.pages import SCRATCH, PageExhausted, PagedSlotPool, PagePool

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

torch.set_num_threads(1)


def _cfg(arch="granite-3-8b"):
    return dataclasses.replace(torch_config(arch), dtype=torch.float32)


def _pool(arch="granite-3-8b", **kw):
    return PagedSlotPool(_cfg(arch), device="cpu", **kw)


def _req_arrays(cfg, pos, seed=0) -> dict:
    """A fake batch-1 prefill result: random normal rows (numpy, so that
    both packages can take them), so that byte checks tell pages apart."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(d.shape).astype(np.float32)
            for k, d in cache_defs(cfg, batch=1, max_len=pos).items()}


def _req_cache(cfg, pos, seed=0) -> dict:
    return {k: torch.from_numpy(a) for k, a in _req_arrays(cfg, pos, seed).items()}


def _page(pool, pid, key=None):
    key = key if key is not None else pool._pkeys[0]
    return pool.cache[key][:, int(pid)].numpy()


# ---------------------------------------------------------------------------
# PagePool: the bare allocator
# ---------------------------------------------------------------------------
def test_pagepool_alloc_free_cycle():
    pool = PagePool(5)
    assert pool.free_count == 4  # scratch is never allocatable
    pids = [pool.alloc() for _ in range(4)]
    assert sorted(pids) == [1, 2, 3, 4] and pool.alloc() is None
    assert pool.decref(pids[0]) and pool.free_count == 1
    assert pool.alloc() == pids[0]  # FIFO reuse of the freed page
    pool.incref(pids[1])
    assert not pool.decref(pids[1])  # still referenced
    assert pool.decref(pids[1])


def test_pagepool_rejects_misuse():
    pool = PagePool(3)
    with pytest.raises(ValueError):
        pool.decref(SCRATCH)  # scratch is pinned for good
    with pytest.raises(ValueError):
        pool.incref(1)  # not allocated
    pid = pool.alloc()
    pool.decref(pid)
    with pytest.raises(ValueError):
        pool.decref(pid)  # double free
    with pytest.raises(ValueError):
        PagePool(1)


def _pagepool_interleaving(ops, num_pages):
    """Any interleaving of alloc / incref / decref conserves refcounts: a
    page is on the free list iff its refcount is 0, decref frees exactly at
    0, and alloc fails only when no page is left."""
    pool = PagePool(num_pages)
    refs = collections.Counter()
    for op, which in ops:
        if op == "alloc":
            pid = pool.alloc()
            if pid is None:
                assert pool.free_count == 0
            else:
                assert refs[pid] == 0
                refs[pid] += 1
        elif not refs:
            continue
        else:
            pid = sorted(refs)[which % len(refs)]
            if op == "incref":
                pool.incref(pid)
                refs[pid] += 1
            else:
                freed = pool.decref(pid)
                refs[pid] -= 1
                assert freed == (refs[pid] == 0)
                if not refs[pid]:
                    del refs[pid]
    for pid in range(1, num_pages):
        assert pool.refcount[pid] == refs.get(pid, 0)
    assert pool.free_count == (num_pages - 1) - len(refs)


if HAVE_HYPOTHESIS:
    @given(st.lists(st.tuples(st.sampled_from(["alloc", "incref", "decref"]),
                              st.integers(0, 63)), max_size=120),
           st.integers(2, 9))
    def test_pagepool_interleavings(ops, num_pages):
        _pagepool_interleaving(ops, num_pages)
else:
    @pytest.mark.parametrize("seed", range(8))
    def test_pagepool_interleavings(seed):
        rng = np.random.default_rng(seed)
        ops = [(rng.choice(["alloc", "incref", "decref"]), int(rng.integers(64)))
               for _ in range(120)]
        _pagepool_interleaving(ops, int(rng.integers(2, 9)))


# ---------------------------------------------------------------------------
# PagedSlotPool: lifecycle invariants
# ---------------------------------------------------------------------------
def test_admit_retire_leaves_no_refs():
    pool = _pool(max_batch=2, max_len=16, page_size=4)
    pool.admit(0, _req_cache(pool.cfg, 5), rid=0, pos=5, budget=4, first_tok=1)
    assert (pool.table[0, :2] != SCRATCH).all()
    assert (pool.table[0, 2:] == SCRATCH).all()
    pool.check_invariants()
    pool.retire(0)
    pool.check_invariants()
    assert pool.pages.free_count == pool.num_pages - 1
    assert (pool.table == SCRATCH).all()


def test_admit_scatters_rows_page_aligned():
    """The rows addressed through the table are the request cache's."""
    pool = _pool(max_batch=2, max_len=16, page_size=4)
    req = _req_cache(pool.cfg, 6)
    pool.admit(0, req, rid=0, pos=6, budget=2, first_tok=1)
    for key in paged_keys(pool.cfg):
        want = req[key][:, 0].numpy()  # (lead, 6, *tail)
        got = np.concatenate([_page(pool, pool.table[0, b], key) for b in range(2)],
                             axis=1)[:, :6]
        np.testing.assert_array_equal(got, want)


def test_cow_fork_never_writes_shared_page():
    pool = _pool(max_batch=3, max_len=16, page_size=4)
    pool.admit(0, _req_cache(pool.cfg, 5), rid=0, pos=5, budget=4, first_tok=1)
    pool.fork_slot(0, 1, rid=1)
    pool.check_invariants()
    assert (pool.table[1, :2] == pool.table[0, :2]).all()
    src_pid = int(pool.table[0, 1])
    assert pool.pages.refcount[src_pid] == 2
    before = _page(pool, src_pid).copy()

    pool.ensure_writable(1, 5, 6)  # a write span inside block 1 only
    pool.check_invariants()
    assert pool.cow_copies == 1
    new_pid = int(pool.table[1, 1])
    assert new_pid != src_pid and pool.table[1, 0] == pool.table[0, 0]
    assert pool.pages.refcount[src_pid] == 1
    # the copy starts equal; the shared original was never touched
    np.testing.assert_array_equal(_page(pool, new_pid), before)
    np.testing.assert_array_equal(_page(pool, src_pid), before)
    pool.ensure_writable(1, 5, 6)  # the writer owns it now: no second copy
    assert pool.cow_copies == 1
    pool.retire(0)
    pool.retire(1)
    pool.check_invariants()
    assert pool.pages.free_count == pool.num_pages - 1


def test_prefix_registry_share_and_survival():
    pool = _pool(max_batch=2, max_len=16, page_size=4, share_prefix=True)
    prompt = np.arange(9, dtype=np.int32)
    pool.admit(0, _req_cache(pool.cfg, 9), rid=0, pos=9, budget=2, first_tok=1, prompt=prompt)
    pool.check_invariants()
    # 2 full blocks registered; a match stops at s0 - 1
    assert pool.match_prefix_len(prompt) == 8
    assert pool.match_prefix_len(np.arange(8, dtype=np.int32)) == 4
    assert pool.match_prefix_len(prompt[::-1].copy()) == 0
    shared = [int(pool.table[0, b]) for b in range(2)]

    pins = pool.pin_prefix(prompt, 8)
    assert pins == shared and pool.shared_hit_pages == 2
    pool._extra_pins = pins
    pool.check_invariants()
    assert all(pool.pages.refcount[p] == 3 for p in pins)  # table + registry + pin
    pool.unpin_prefix(pins)
    del pool._extra_pins

    pool.retire(0)  # the registry keeps the pages past their owner
    pool.check_invariants()
    assert pool.match_prefix_len(prompt) == 8
    assert all(pool.pages.refcount[p] == 1 for p in shared)


def test_registry_lru_eviction_under_pressure():
    # 7 allocatable pages; the retired prompt leaves 2 registry-only pages
    pool = _pool(max_batch=2, max_len=16, page_size=4, num_pages=8, share_prefix=True)
    prompt = np.arange(8, dtype=np.int32)
    pool.admit(0, _req_cache(pool.cfg, 8), rid=0, pos=8, budget=2, first_tok=1, prompt=prompt)
    pool.retire(0)
    assert pool.match_prefix_len(np.arange(9, dtype=np.int32)) == 8
    assert pool._evictable() == 2 and pool.pages.free_count == 5

    pool.admit(0, _req_cache(pool.cfg, 15), rid=1, pos=15, budget=1, first_tok=1)
    assert pool.can_admit(8, 1)  # 2 blocks <= 1 free + 2 evictable
    pool.admit(1, _req_cache(pool.cfg, 8), rid=2, pos=8, budget=1, first_tok=1)
    assert pool.evictions == 1  # the LRU registry page recycled
    pool.check_invariants()
    assert pool.match_prefix_len(np.arange(9, dtype=np.int32)) < 8


def test_can_admit_counts_outstanding_reservations():
    pool = _pool(max_batch=4, max_len=16, page_size=4, num_pages=6)  # 5 allocatable
    assert pool.can_admit(8, 8)  # 4 blocks <= 5
    pool.reserve(0, rid=0, s0=8, budget=8)  # a group member, prefill in flight
    assert not pool.can_admit(8, 8)  # its 4 reserved pages are spoken for
    assert pool.can_admit(4, 1)
    assert pool.can_admit(8, 8, shared_len=4 * 3)  # a shared prefix comes from the registry
    assert pool.reserved_admitting() == 4
    pool.retire(0)
    assert pool.can_admit(8, 8) and pool.reserved_admitting() == 0
    pool.check_invariants()


def test_poison_taints_and_scrubs_on_reuse():
    # 7 allocatable pages, so that the admissions below drain the whole free
    # list and every tainted page is allocated (and zeroed) again
    pool = _pool(max_batch=2, max_len=16, page_size=4, num_pages=8, share_prefix=True)
    prompt = np.arange(8, dtype=np.int32)
    pool.admit(0, _req_cache(pool.cfg, 8), rid=0, pos=8, budget=2, first_tok=1, prompt=prompt)
    registered = [int(pool.table[0, b]) for b in range(2)]
    pool.poison(0)
    pool.check_invariants()
    # registry pages were copied first: the NaNs are in the copies
    assert pool.cow_copies == 2
    for pid in registered:
        assert np.isfinite(_page(pool, pid)).all()
    for b in range(2):
        assert np.isnan(_page(pool, pool.table[0, b])).all()

    pool.retire(0)
    assert pool._tainted and not pool._slot_tainted
    pool.admit(0, _req_cache(pool.cfg, 15), rid=1, pos=15, budget=1, first_tok=1)
    pool.admit(1, _req_cache(pool.cfg, 12), rid=2, pos=12, budget=1, first_tok=1)
    assert not pool._tainted
    for key in paged_keys(pool.cfg):
        assert torch.isfinite(pool.cache[key]).all()
    pool.check_invariants()


def _random_lifecycle(seed):
    """Random interleavings of admit / fork / write / poison / retire, swap
    and unswap, pressure pins and their release keep refcounts conserved
    after every operation, and leak nothing."""
    pool = _pool(max_batch=3, max_len=16, page_size=4, share_prefix=True)
    cfg = pool.cfg
    rng = np.random.default_rng(seed)
    images: list[dict] = []
    pins: list[int] = []
    for _ in range(40):
        free = [s for s in range(3) if not pool.active[s]]
        live = [s for s in range(3) if pool.active[s]]
        clean = [s for s in live if s not in pool._slot_tainted]
        op = rng.choice(["admit", "fork", "write", "poison", "retire", "swap", "unswap",
                         "press", "release"])
        if op == "admit" and free:
            pos = int(rng.integers(2, 13))
            prompt = rng.integers(0, 64, pos).astype(np.int32)
            if pool.can_admit(pos, 3):
                try:
                    pool.admit(free[0], _req_cache(cfg, pos, seed=int(rng.integers(99))),
                               rid=int(rng.integers(1 << 20)), pos=pos, budget=3, first_tok=1,
                               prompt=prompt)
                except PageExhausted:
                    pass  # pressure pins may beat the estimate; unwound
        elif op == "fork" and free and live:
            pool.fork_slot(live[0], free[0], rid=int(rng.integers(1 << 20)))
        elif op == "write" and live:
            s = live[int(rng.integers(len(live)))]
            p = pool.slots[s].pos
            try:
                pool.ensure_writable(s, p, p + 1)
            except PageExhausted:
                pass
        elif op == "poison" and live:
            pool.poison(live[int(rng.integers(len(live)))])
        elif op == "retire" and live:
            pool.retire(live[int(rng.integers(len(live)))])
        elif op == "swap" and clean:
            images.append(pool.swap_out(clean[int(rng.integers(len(clean)))]))
        elif op == "unswap" and images and free:
            img = images.pop()
            try:
                pool.swap_in(free[0], img)
            except PageExhausted:
                images.append(img)
        elif op == "press":
            pins.extend(pool.pin_free_pages(int(rng.integers(1, 3))))
        elif op == "release" and pins:
            pool.unpin_pages(pins)
            pins = []
        pool.check_invariants()
    if pins:
        pool.unpin_pages(pins)
    for s in range(3):
        if pool.active[s]:
            pool.retire(s)
    pool.check_invariants()
    assert pool.pages.free_count == pool.num_pages - 1 - len(pool._prefix)


if HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 10_000))
    def test_random_lifecycle_interleavings(seed):
        _random_lifecycle(seed)
else:
    @pytest.mark.parametrize("seed", range(4))
    def test_random_lifecycle_interleavings(seed):
        _random_lifecycle(seed)


# ---------------------------------------------------------------------------
# Typed exhaustion, swap round trip, page-pressure pins
# ---------------------------------------------------------------------------
def test_exhaustion_is_typed_and_unwinds_admit():
    pool = _pool(max_batch=2, max_len=16, page_size=4, num_pages=4)  # 3 allocatable
    free_before = pool.pages.free_count
    with pytest.raises(PageExhausted) as ei:
        pool.admit(0, _req_cache(pool.cfg, 14), rid=0, pos=14, budget=1, first_tok=1)
    assert not isinstance(ei.value, RuntimeError) and ei.value.need >= 1
    pool.check_invariants()
    assert pool.pages.free_count == free_before
    assert not pool.active[0] and pool.free_count == 2
    pool.admit(0, _req_cache(pool.cfg, 8), rid=1, pos=8, budget=2, first_tok=1)
    pool.check_invariants()


def test_exhaustion_is_typed_in_ensure_writable():
    pool = _pool(max_batch=2, max_len=16, page_size=4, num_pages=4)
    pool.admit(0, _req_cache(pool.cfg, 8), rid=0, pos=8, budget=8, first_tok=1)
    pins = pool.pin_free_pages(pool.pages.free_count)  # drain the free list
    assert pool.blocks_needed(0, 8, 9) == 1  # the next block is unmapped
    with pytest.raises(PageExhausted):
        pool.ensure_writable(0, 8, 9)
    pool.check_invariants()
    pool.unpin_pages(pins)
    pool.ensure_writable(0, 8, 9)
    assert pool.blocks_needed(0, 8, 9) == 0
    pool.check_invariants()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_swap_roundtrip_is_bit_identical(kv_quant):
    """swap_out → swap_in restores the slot byte for byte (pages through the
    table, int8 payloads and their scales, unpaged rows) and its bookkeeping
    (rid, pos, budget, emitted, tier, next token), in another slot."""
    pool = _pool("zamba2-7b", max_batch=2, max_len=16, page_size=4, kv_quant=kv_quant)
    pool.admit(0, _req_cache(pool.cfg, 10), rid=7, pos=10, budget=5, first_tok=3)
    pool.slots[0].tier = "latency"
    pool.advance(0, 2, next_tok=9)  # mid-decode: pos 12, emitted 3

    def snapshot(slot):
        nb = pool._blocks_for(pool.slots[slot].pos)
        paged = {k: np.concatenate([_page(pool, pool.table[slot, b], k) for b in range(nb)],
                                   axis=1) for k in pool._pleaves}
        rows = {k: v[:, slot].numpy().copy() for k, v in pool.cache.items()
                if k not in pool._pleaves}
        return paged, rows

    assert set(pool._pleaves) == ({"shared_k", "shared_v"} | (
        {"shared_k_scale", "shared_v_scale"} if kv_quant else set()))
    want_pages, want_rows = snapshot(0)
    est = pool.swap_image_bytes(0)
    image = pool.swap_out(0)
    pool.check_invariants()
    assert not pool.active[0] and pool.swap_outs == 1
    assert image["bytes"] == est > 0 and pool.swapped_bytes == est
    pool.swap_in(1, image)
    pool.check_invariants()
    got_pages, got_rows = snapshot(1)
    for k in want_pages:
        np.testing.assert_array_equal(got_pages[k], want_pages[k])
    for k in want_rows:
        np.testing.assert_array_equal(got_rows[k], want_rows[k])
    info = pool.slots[1]
    assert (info.rid, info.pos, info.budget, info.emitted, info.tier) == (7, 12, 5, 3, "latency")
    assert int(pool.tok[1]) == 9 and pool.swap_ins == 1


def test_swap_in_unwinds_on_exhaustion():
    pool = _pool(max_batch=2, max_len=16, page_size=4, num_pages=6)
    pool.admit(0, _req_cache(pool.cfg, 10), rid=0, pos=10, budget=2, first_tok=1)
    image = pool.swap_out(0)
    pins = pool.pin_free_pages(pool.pages.free_count)
    with pytest.raises(PageExhausted):
        pool.swap_in(0, image)
    pool.check_invariants()
    assert not pool.active[0] and pool.free_count == 2
    pool.unpin_pages(pins)
    pool.swap_in(0, image)  # the image survives a failed restore
    assert pool.slots[0].rid == 0 and pool.slots[0].pos == 10
    pool.check_invariants()


def test_press_pins_shrink_and_restore_the_pool():
    pool = _pool(max_batch=2, max_len=16, page_size=4, num_pages=6)
    before = pool.pages.free_count
    pins = pool.pin_free_pages(2)
    assert len(pins) == 2 and pool.pages.free_count == before - 2
    pool.check_invariants()
    more = pool.pin_free_pages(before)  # asking for more pins only what exists
    assert len(more) == before - 2 and pool.pages.free_count == 0
    pool.check_invariants()
    pool.unpin_pages(pins)
    pool.unpin_pages(more)
    assert pool.pages.free_count == before
    pool.check_invariants()


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ("granite-3-8b", "whisper-tiny", "mamba2-780m"))
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_cache_bytes_matches_allocation(arch, kv_quant):
    """``paged_cache_bytes`` is what the pool allocates (pages, unpaged
    per-slot leaves, the int32 table) and the JAX package's count."""
    pool = _pool(arch, max_batch=2, max_len=16, page_size=4, kv_quant=kv_quant)
    actual = sum(v.nbytes for v in pool.cache.values()) + pool.table.nbytes
    kw = dict(batch=2, num_pages=pool.num_pages, page_size=4, max_blocks=pool.max_blocks,
              kv_quant=kv_quant)
    assert actual == paged_cache_bytes(pool.cfg, **kw)
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32)
    assert actual == jax_kv.paged_cache_bytes(jcfg, **kw)
    want = jax_kv.page_defs(jcfg, num_pages=9, page_size=4, kv_quant=kv_quant)
    got = page_defs(pool.cfg, num_pages=9, page_size=4, kv_quant=kv_quant)
    assert {k: (d.shape, d.logical) for k, d in got.items()} == \
        {k: (d.shape, d.logical) for k, d in want.items()}
    with pytest.raises(ValueError):
        page_defs(pool.cfg, num_pages=9, page_size=4, kv_quant="int4")


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------
def test_quantize_kv_gives_the_jax_bytes():
    """Rows of random values, rows whose quotients land exactly on half-way
    ties (rounded to even), an all-zero row (the 1e-8 floor), a row holding
    a NaN (a NaN scale and zero payloads) and one holding an infinity."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[0, 0] = np.arange(16) - 7.5                       # amax 7.5: scale 7.5/127
    x[0, 1] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5] + [0.0] * 9 + [127.0]  # scale 1: x.5 ties
    x[0, 2] = 0.0
    x[1, 0, 3] = np.nan
    x[1, 1, 7] = np.inf
    jq, js = jax_kv.quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert np.isnan(ts.numpy()[1, 0]) and (tq.numpy()[1, 0] == 0).all()
    assert list(tq.numpy()[0, 1, :6]) == [0, 2, 2, 0, -2, -2]  # half to even
    np.testing.assert_array_equal(
        dequantize_kv(tq, ts).numpy(), np.asarray(jax_kv.dequantize_kv(jq, js)))
    np.testing.assert_array_equal(
        dequantize_kv(tq, ts, torch.bfloat16).float().numpy(),
        np.asarray(jax_kv.dequantize_kv(jq, js, jnp.bfloat16)).astype(np.float32))


def _jax_cache(arrays):
    return {k: jnp.asarray(a) for k, a in arrays.items()}


def _same_pools(tp, jp) -> None:
    np.testing.assert_array_equal(tp.table, jp.table)
    np.testing.assert_array_equal(tp.pages.refcount, jp.pages.refcount)
    assert list(tp.pages._free) == list(jp.pages._free)
    assert list(tp._prefix.items()) == list(jp._prefix.items())
    np.testing.assert_array_equal(tp._resv, jp._resv)
    np.testing.assert_array_equal(tp._owned, jp._owned)
    assert (tp._tainted, tp._slot_tainted, tp._press_pins) == \
        (jp._tainted, jp._slot_tainted, jp._press_pins)
    for name in ("cow_copies", "shared_hit_pages", "evictions", "swap_outs", "swap_ins",
                 "swapped_bytes", "free_count", "active_count"):
        assert getattr(tp, name) == getattr(jp, name), name
    np.testing.assert_array_equal(tp.active, jp.active)
    np.testing.assert_array_equal(tp.positions(), jp.positions())
    np.testing.assert_array_equal(tp.tok, jp.tok)
    assert [(s.rid, s.pos, s.budget, s.emitted, s.tier) for s in tp.slots] == \
        [(s.rid, s.pos, s.budget, s.emitted, s.tier) for s in jp.slots]
    assert set(tp.cache) == set(jp.cache)
    for key, leaf in tp.cache.items():
        same_leaf(key, leaf.numpy(), np.asarray(jp.cache[key]))


def same_leaf(key: str, got: np.ndarray, want: np.ndarray) -> None:
    """Equal bytes, but for int8 pages' scales: within one f32 ulp.  The JAX
    pool quantizes inside ``jax.jit``, where XLA turns ``amax / 127`` into a
    product with the reciprocal of 127, one rounding more; the port divides,
    as the JAX package's ``quantize_kv`` does outside a jit
    (``test_quantize_kv_gives_the_jax_bytes``).  The payloads come out
    equal."""
    if not key.endswith("_scale"):
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=key)
    np.testing.assert_array_max_ulp(got[~nan], want[~nan], maxulp=1)


@pytest.mark.parametrize("arch,kv_quant", [("granite-3-8b", None), ("granite-3-8b", "int8"),
                                           ("zamba2-7b", None)])
def test_seeded_script_matches_the_jax_pool(arch, kv_quant):
    """One seeded script of admit (with prompts that share prefixes), fork,
    ensure_writable, poison, retire, swap out and in, pins and their
    release, on the JAX pool and on the port's: after every operation the
    same table, refcounts, free-list order, registry, reservations, taint,
    counters, slots and page bytes, exactly (int8 scales within one ulp:
    ``same_leaf``).  Both take the same numpy rows."""
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32)
    kw = dict(max_batch=3, max_len=16, page_size=4, num_pages=14, share_prefix=True,
              kv_quant=kv_quant)
    tp, jp = PagedSlotPool(cfg, device="cpu", **kw), JaxPagedSlotPool(jcfg, **kw)
    rng = np.random.default_rng(17)
    base = rng.integers(0, 64, 12).astype(np.int32)
    images, pins = [], []
    ops = collections.Counter()
    # every kind of operation once, in an order where each can act, then a
    # seeded random sequence
    script = ["admit", "admit", "fork", "write", "swap", "admit", "unswap", "press", "poison",
              "retire", "release"]
    script += [str(op) for op in rng.choice(["admit", "admit", "fork", "write", "write",
                                             "poison", "retire", "swap", "unswap", "press",
                                             "release"], 40)]
    for op in script:
        free = [s for s in range(3) if not tp.active[s]]
        live = [s for s in range(3) if tp.active[s]]
        clean = [s for s in live if s not in tp._slot_tainted]
        if op == "admit" and free:
            pos = int(rng.integers(2, 13))
            prompt = base[:pos].copy() if rng.random() < 0.6 else \
                rng.integers(0, 64, pos).astype(np.int32)
            if not tp.can_admit(pos, 3):
                assert not jp.can_admit(pos, 3)
                continue
            rows = _req_arrays(cfg, pos, seed=int(rng.integers(99)))
            kws = dict(rid=int(rng.integers(1 << 20)), pos=pos, budget=3, first_tok=1,
                       prompt=prompt)
            outcome = []
            for pool, cache in ((tp, {k: torch.from_numpy(a) for k, a in rows.items()}),
                                (jp, _jax_cache(rows))):
                try:
                    pool.admit(free[0], cache, **kws)
                    outcome.append("admitted")
                except PageExhausted:
                    outcome.append("exhausted")
                except Exception as e:  # the JAX pool's own class
                    assert type(e).__name__ == "PageExhausted", e
                    outcome.append("exhausted")
            assert outcome[0] == outcome[1]
        elif op == "fork" and free and live:
            for pool in (tp, jp):
                pool.fork_slot(live[0], free[0], rid=int(1000 + len(ops)))
        elif op == "write" and live:
            s = live[int(rng.integers(len(live)))]
            p = tp.slots[s].pos
            for pool in (tp, jp):
                try:
                    pool.ensure_writable(s, p, p + 1)
                except Exception as e:
                    assert type(e).__name__ == "PageExhausted", e
        elif op == "poison" and live:
            s = live[int(rng.integers(len(live)))]
            for pool in (tp, jp):
                pool.poison(s)
        elif op == "retire" and live:
            s = live[int(rng.integers(len(live)))]
            for pool in (tp, jp):
                pool.retire(s)
        elif op == "swap" and clean:
            s = clean[int(rng.integers(len(clean)))]
            timg, jimg = tp.swap_out(s), jp.swap_out(s)
            assert timg["bytes"] == jimg["bytes"]
            for k in jimg["pages"]:
                same_leaf(k, timg["pages"][k].numpy(), jimg["pages"][k])
            images.append((timg, jimg))
        elif op == "unswap" and images and free:
            timg, jimg = images.pop()
            outcome = []
            for pool, img in ((tp, timg), (jp, jimg)):
                try:
                    pool.swap_in(free[0], img)
                    outcome.append(True)
                except Exception as e:
                    assert type(e).__name__ == "PageExhausted", e
                    outcome.append(False)
            assert outcome[0] == outcome[1]
            if not outcome[0]:
                images.append((timg, jimg))
        elif op == "press":
            n = int(rng.integers(1, 3))
            got = tp.pin_free_pages(n)
            assert got == jp.pin_free_pages(n)
            pins += got
        elif op == "release" and pins:
            tp.unpin_pages(pins)
            jp.unpin_pages(pins)
            pins = []
        else:
            continue
        ops[op] += 1
        tp.check_invariants()
        _same_pools(tp, jp)
    # the script reached every kind of operation; sharing happened where it is on
    assert set(ops) == {"admit", "fork", "write", "poison", "retire", "swap", "unswap", "press",
                        "release"}, ops
    assert bool(tp._prefix) == tp.share_prefix  # off for the hybrid family
