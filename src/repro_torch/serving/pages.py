"""Paged KV cache: physical pages, a page table, and copy-on-write sharing of
prompt prefixes (the serving analogue of the paper's application-specific
provisioning: a slot pays for the pages it maps, not for a worst case).

Logical blocks and physical pages
---------------------------------

The contiguous ``SlotPool`` gives every slot ``max_len + slack`` cache rows.
Here the sequence leaves of each family (``kv_cache.paged_keys``) are one
shared array of physical pages, ``(lead, num_pages, page_size, ...)``, and
a slot's positions are split into logical blocks of ``page_size`` rows:

  position p  ->  block p // page_size, row p % page_size in that block
  the row of a leaf = pages[:, table[slot, p // page_size], p % page_size]

``table`` is a dense ``(max_batch, max_blocks)`` int32 array on the host;
the engine copies it into one more static input of its captured decode and
verify ticks (``serving/graphs.py``), whose bodies gather every slot's
virtual contiguous row through it (``models.model.paged_virtual_cache``)
and scatter the written blocks back by page id.  Page 0 is the SCRATCH
page: unmapped entries point at it, so a gather of a block never written
reads garbage that the positional masks keep inert, and writes of inactive
slots and of verify blocks past a window land in it.  What is O(1) in the
sequence (SSM conv/state, whisper's cross K/V) keeps the per-slot layout.

Allocation, refcounts, copy-on-write
------------------------------------

``PagePool`` is the allocator: a FIFO free list and a refcount a page.

  * a page is free iff its refcount is 0; ``alloc`` sets it to 1, every
    further mapping (a shared prefix, a fork, a registry entry) adds one,
    every unmapping takes one, and a page returns to the free list exactly
    when it reaches 0.
  * a slot writes only blocks whose page it owns alone (refcount 1).
    ``ensure_writable`` runs before every tick's write span: unmapped blocks
    get fresh pages, shared blocks are copied to a fresh page first and the
    slot's entry repointed; a shared page is never written in place.
  * the prefix registry holds one reference a registered page, so such a
    page has refcount >= 2 while a slot maps it and keeps its bytes at
    refcount 1 after its owner retires; those registry-only pages are the
    LRU eviction pool when the free list runs dry.

Prefix sharing hashes a prompt's full blocks (a blake2b chain, so the
digest of block j commits to every token before it) and registers each
full prompt block's page.  A later prompt that matches a registered chain
maps those pages read-only and its chunked prefill starts at the shared
length.  At most ``s0 - 1`` tokens are shared: the first emitted token
comes from the logits at the last prompt position, which the consumer
computes itself.  Sharing is off for the ssm and hybrid families (their
recurrent state is not positional) and for front-end families (the digest
covers tokens, not the per-request front-end input).

Verify windows need no ``spec_slack`` rows: the table has at least one
spare block past ``max_len``, and tail blocks are allocated on demand.

Memory pressure
---------------

``can_admit`` bounds the co-resident reservations, but a tick can still
outrun the pool (verify tails past a reservation, ``poison``'s forced
copies, registry pages evicted between probe and allocation, page-pressure
pins).  Exhaustion is a scheduling event: ``_alloc_page`` returns a
``PageExhausted`` signal instead of raising, and every caller unwinds
(``admit``, ``swap_in``) or flushes its copies (``ensure_writable``) before
raising it.  The scheduler sums ``blocks_needed`` over the decoding slots
before a tick and preempts by ``swap_out`` (pages [0, pos) and the unpaged
rows to host buffers) and ``swap_in`` (fresh pages, the same bytes), or by
recomputing through the engine's ``resume_into_slot``.

How the JAX package's idioms are expressed here: each of its pool-owned
jits is an in-place operation on the pool's tensors (``index_copy_`` along
the page axis, row writes), and ``cache`` and its tensors are never
rebound, since the captured ticks hold their addresses.  The host
bookkeeping (table, refcounts, free-list order, counters) is numpy and
follows the JAX package operation for operation.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import init_params
from repro_torch.serving.kv_cache import (cache_defs, dequantize_kv, page_defs, paged_keys,
                                          quantize_kv)
from repro_torch.serving.slots import SlotInfo, SlotPool

SCRATCH = 0  # reserved physical page: unmapped and redirected writes land here


class PageExhausted(Exception):
    """The page pool (free list plus LRU-evictable registry pages) cannot
    supply the pages asked for.  ``_alloc_page`` returns an instance instead
    of raising, so that lifecycle methods unwind first and then raise it for
    the scheduler, which preempts."""

    def __init__(self, need: int = 1, free: int = 0):
        super().__init__(f"page pool exhausted: need {need} page(s), {free} free/evictable")
        self.need = need
        self.free = free


class PagePool:
    """Free list and per-page refcounts over ``num_pages`` physical pages;
    page ``SCRATCH`` is pinned for good and never allocated.  Host-side
    bookkeeping only: the pages' tensors live in ``PagedSlotPool``."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("a page pool needs at least one page beyond scratch")
        self.num_pages = num_pages
        self.refcount = np.zeros(num_pages, np.int64)
        self.refcount[SCRATCH] = 1
        self._free = collections.deque(range(1, num_pages))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self) -> int | None:
        """Pop a free page (refcount 0 → 1); None when none is left."""
        if not self._free:
            return None
        pid = self._free.popleft()
        assert self.refcount[pid] == 0, f"page {pid} on the free list with references"
        self.refcount[pid] = 1
        return pid

    def _check_mapped(self, pid: int) -> None:
        if pid == SCRATCH or self.refcount[pid] < 1:
            raise ValueError(f"page {pid} is scratch or not allocated")

    def incref(self, pid: int) -> None:
        self._check_mapped(pid)
        self.refcount[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when that freed the page."""
        self._check_mapped(pid)
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)
            return True
        return False


def _ids(pids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(pids, np.int64).reshape(-1), device=device)


class PagedSlotPool(SlotPool):
    """The paged counterpart of ``SlotPool`` (see the module docstring).

    ``cache`` mixes paged leaves ``(lead, num_pages, page_size, ...)`` with
    the unpaged per-slot leaves at their ``(lead, max_batch, ...)`` layout;
    ``table`` maps each slot's logical blocks to page ids.  A scheduler
    drives it through the contiguous pool's surface plus the page-budget
    methods (``can_admit``, ``require_pages``, ``blocks_needed``,
    ``reserved_admitting``)."""

    def __init__(self, cfg: ArchConfig, *, max_batch: int, max_len: int, page_size: int = 16,
                 slack: int = 0, num_pages: int | None = None, share_prefix: bool = False,
                 kv_quant: str | None = None, device=None):
        super().__init__(cfg, max_batch=max_batch, max_len=max_len, slack=slack, virtual=True,
                         device=device)
        self.page = int(page_size)
        if self.page < 1:
            raise ValueError(f"page_size {page_size} < 1")
        # verify headroom in place of spec_slack rows: at least one spare block
        # past max_len (more when slack asks), plus one block so that a window
        # starting at max_len - 2 always fits the table
        headroom = max(slack, self.page)
        self.max_blocks = -(-(max_len + headroom) // self.page) + 1
        self.virtual_len = self.max_blocks * self.page
        self.capacity = self.virtual_len  # what the gathered rows span
        self._pkeys = paged_keys(cfg)
        # int8 pages: payloads int8, an f32 scale a row in a "{key}_scale"
        # leaf; page-index operations (copy, zero, swap, restore, scrub) treat
        # both alike through _pleaves, only the quantize and dequantize sites
        # know which is which
        self.kv_quant = kv_quant if self._pkeys else None
        self._skeys = tuple(f"{k}_scale" for k in self._pkeys) if self.kv_quant else ()
        self._pleaves = self._pkeys + self._skeys
        self.share_prefix = (bool(share_prefix) and cfg.family not in ("ssm", "hybrid")
                             and cfg.frontend is None)
        if num_pages is None:
            # the contiguous pool's worst case plus scratch: on-demand tail
            # allocation never fails at this size
            num_pages = max_batch * self.max_blocks + 1
        self.num_pages = int(num_pages)
        self.pages = PagePool(self.num_pages)
        self.table = np.zeros((max_batch, self.max_blocks), np.int32)
        defs = dict(page_defs(cfg, num_pages=self.num_pages, page_size=self.page,
                              kv_quant=self.kv_quant))
        for key, d in cache_defs(cfg, batch=max_batch, max_len=1).items():
            if key not in self._pkeys:
                defs[key] = d  # unpaged leaves do not depend on max_len
        self.cache = init_params(defs, torch.Generator(), self.device)
        # prefix registry: digest chain -> page id, in LRU order; each entry
        # holds one reference
        self._prefix: collections.OrderedDict[bytes, int] = collections.OrderedDict()
        self._resv = np.zeros(max_batch, np.int64)   # pages a slot may come to need
        self._owned = np.zeros(max_batch, np.int64)  # pages it has
        # NaN hygiene: pages freed from a poisoned slot are zeroed when they
        # are allocated again; the slot's unpaged rows are zeroed at retire
        self._tainted: set[int] = set()
        self._slot_tainted: set[int] = set()
        self.cow_copies = 0
        self.shared_hit_pages = 0
        self.evictions = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_bytes = 0
        self._press_pins: list[int] = []  # page-pressure fault: free pages pinned out

    # -- device-side primitives: in place on the pool's tensors -------------
    def _store_blocks(self, key: str, pids: torch.Tensor, blocks: torch.Tensor) -> None:
        """Write ``blocks`` (lead, n, page, *tail) to pages ``pids`` of leaf
        ``key``, quantized on the way under ``kv_quant``."""
        leaf = self.cache[key]
        if self.kv_quant:
            q, s = quantize_kv(blocks)
            leaf.index_copy_(1, pids, q)
            self.cache[f"{key}_scale"].index_copy_(1, pids, s)
        else:
            leaf.index_copy_(1, pids, blocks.to(leaf.dtype))

    def _admit_rows(self, req_cache: dict, slot: int, pids: list[int]) -> None:
        """Land a batch-1 request cache: paged leaves padded to whole blocks
        and stored in ``pids``; unpaged leaves over the slot's row."""
        ids, nb = _ids(pids, self.device), len(pids)
        for key, leaf in self.cache.items():
            if key in self._skeys:
                continue
            if key in self._pkeys:
                r = req_cache[key][:, 0]  # (lead, s, *tail)
                pad = torch.zeros((r.shape[0], nb * self.page - r.shape[1], *r.shape[2:]),
                                  dtype=r.dtype, device=r.device)
                r = torch.cat([r, pad], dim=1)
                self._store_blocks(key, ids, r.reshape(r.shape[0], nb, self.page, *r.shape[2:]))
            else:
                leaf[:, slot] = req_cache[key][:, 0].to(leaf.dtype)

    def _activate_rows(self, group_cache: dict, slot: int, j: int, pids: list[int], bs: int,
                       nb: int) -> None:
        """Land row ``j`` of a chunked group's cache: its blocks [bs, nb) to
        ``pids``, its unpaged leaves over the slot's row.  The shared prefix
        blocks are resident already; only the table maps them."""
        ids = _ids(pids, self.device)
        for key, leaf in self.cache.items():
            if key in self._skeys:
                continue
            row = group_cache[key][:, j]
            if key in self._pkeys:
                r = row[:, bs * self.page:nb * self.page]
                self._store_blocks(key, ids, r.reshape(r.shape[0], nb - bs, self.page,
                                                       *r.shape[2:]))
            else:
                leaf[:, slot] = row.to(leaf.dtype)

    def _copy_pages(self, srcs: list[int], dsts: list[int]) -> None:
        src, dst = _ids(srcs, self.device), _ids(dsts, self.device)
        for key in self._pleaves:
            leaf = self.cache[key]
            leaf.index_copy_(1, dst, leaf.index_select(1, src))

    def _zero_pages(self, pids: list[int]) -> None:
        ids = _ids(pids, self.device)
        for key in self._pleaves:
            self.cache[key].index_fill_(1, ids, 0)

    def _unpaged(self):
        return ((k, v) for k, v in self.cache.items() if k not in self._pleaves)

    # -- page accounting -----------------------------------------------------
    def _blocks_for(self, extent: int) -> int:
        """Blocks covering cache positions [0, extent)."""
        return max(1, -(-extent // self.page))

    def _evictable(self) -> int:
        return sum(1 for pid in self._prefix.values() if self.pages.refcount[pid] == 1)

    def _outstanding(self) -> int:
        """Pages occupied slots (admitting ones too) have reserved but not
        yet allocated."""
        return int(np.maximum(self._resv - self._owned, 0)[self.active].sum())

    def can_admit(self, s0: int, budget: int, *, shared_len: int = 0) -> bool:
        """A free slot, and pages (free, plus LRU-evictable registry pages,
        less what admitted slots still have reserved) for the request's worst
        case net of its shared prefix blocks."""
        if self.free_count == 0:
            return False
        need = self._blocks_for(s0 + budget - 1) - shared_len // self.page
        return need <= self.pages.free_count + self._evictable() - self._outstanding()

    def _evict_one(self) -> bool:
        """Drop the least recently used registry-only page (refcount 1)."""
        for digest, pid in self._prefix.items():
            if self.pages.refcount[pid] == 1:
                del self._prefix[digest]
                freed = self.pages.decref(pid)
                assert freed
                self.evictions += 1
                return True
        return False

    def _alloc_page(self) -> int | PageExhausted:
        """One fresh page, evicting an LRU registry page if the free list is
        dry; a ``PageExhausted`` signal (returned, not raised) when none is
        left.  A page freed by a poisoned slot is zeroed first."""
        pid = self.pages.alloc()
        if pid is None and self._evict_one():
            pid = self.pages.alloc()
        if pid is None:
            return PageExhausted(need=1, free=self.pages.free_count)
        if pid in self._tainted:
            self._zero_pages([pid])
            self._tainted.discard(pid)
        return pid

    def _alloc_pages(self, n: int) -> list[int] | PageExhausted:
        """``n`` fresh pages, all or none: on exhaustion the pages taken are
        given back and the signal returned."""
        pids: list[int] = []
        for _ in range(n):
            pid = self._alloc_page()
            if isinstance(pid, PageExhausted):
                for p in pids:
                    self.pages.decref(p)
                return PageExhausted(need=n, free=self.pages.free_count)
            pids.append(pid)
        return pids

    def require_pages(self, n: int) -> None:
        """Make ``n`` pages obtainable now (evicting registry pages) or raise
        ``PageExhausted``: a multi-slot commit checks before it touches any
        slot."""
        while self.pages.free_count < n and self._evict_one():
            pass
        if self.pages.free_count < n:
            raise PageExhausted(need=n, free=self.pages.free_count)

    def reserved_admitting(self) -> int:
        """Worst-case pages still owed to admitting groups: the share of the
        pool a decode or verify tick must leave alone."""
        occ = self.active & self.admitting
        return int(np.maximum(self._resv - self._owned, 0)[occ].sum())

    def blocks_needed(self, slot: int, start: int, end: int) -> int:
        """Fresh pages ``ensure_writable(slot, start, end)`` would allocate
        now: unmapped blocks and shared blocks that need a copy."""
        need = 0
        for blk in range(start // self.page, (end - 1) // self.page + 1):
            pid = int(self.table[slot, blk])
            if pid == SCRATCH or self.pages.refcount[pid] > 1:
                need += 1
        return need

    def pin_free_pages(self, n: int) -> list[int]:
        """Page-pressure fault: pin up to ``n`` free pages out of the pool
        (no eviction: the squeeze is transient); ``unpin_pages`` gives them
        back."""
        pids: list[int] = []
        for _ in range(n):
            pid = self.pages.alloc()
            if pid is None:
                break
            pids.append(pid)
        self._press_pins.extend(pids)
        return pids

    def unpin_pages(self, pids) -> None:
        for pid in pids:
            self._press_pins.remove(pid)
            self.pages.decref(pid)

    # -- prefix registry -----------------------------------------------------
    def _block_digests(self, prompt: np.ndarray) -> list[bytes]:
        """Chained digests over full blocks: digest j commits to every token
        of blocks 0..j."""
        out = []
        h = hashlib.blake2b(b"kv-prefix", digest_size=16).digest()
        for j in range(len(prompt) // self.page):
            blk = np.ascontiguousarray(prompt[j * self.page:(j + 1) * self.page], dtype=np.int32)
            h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
            out.append(h)
        return out

    def match_prefix_len(self, prompt) -> int:
        """Tokens of ``prompt``'s longest registered block-aligned prefix,
        at most s0 - 1 (the consumer prefills the last prompt position)."""
        if not self.share_prefix:
            return 0
        prompt = np.asarray(prompt, np.int32)
        cap = (len(prompt) - 1) // self.page
        m = 0
        for d in self._block_digests(prompt)[:cap]:
            if d not in self._prefix:
                break
            self._prefix.move_to_end(d)
            m += 1
        return m * self.page

    def pin_prefix(self, prompt, shared_len: int) -> list[int]:
        """One reference on each page of ``prompt``'s matched prefix for one
        consumer; the references pass to its table at activation, or back
        through ``unpin_prefix``."""
        digests = self._block_digests(np.asarray(prompt, np.int32))[:shared_len // self.page]
        pids = [self._prefix[d] for d in digests]
        for pid in pids:
            self.pages.incref(pid)
        self.shared_hit_pages += len(pids)
        return pids

    def unpin_prefix(self, pids) -> None:
        for pid in pids:
            self.pages.decref(pid)

    def _register_prompt(self, slot: int, prompt: np.ndarray) -> None:
        """Publish the slot's full prompt blocks, one registry reference a
        page; partial blocks are never registered."""
        for j, d in enumerate(self._block_digests(prompt)):
            if d in self._prefix:
                self._prefix.move_to_end(d)
                continue
            pid = int(self.table[slot, j])
            if pid == SCRATCH:
                break
            self.pages.incref(pid)
            self._prefix[d] = pid

    # -- write preparation (copy-on-write) -----------------------------------
    def ensure_writable(self, slot: int, start: int, end: int) -> None:
        """Make positions [start, end) of ``slot`` writable: fresh pages for
        unmapped blocks, a copy for shared ones.  Runs on the host before
        every tick; the copies are enqueued on the current stream, ahead of
        the tick."""
        if not self.active[slot] or self.admitting[slot]:
            raise ValueError(f"slot {slot} is not decoding")
        srcs, dsts = [], []
        try:
            for blk in range(start // self.page, (end - 1) // self.page + 1):
                pid = int(self.table[slot, blk])
                if pid == SCRATCH:
                    npid = self._alloc_page()
                    if isinstance(npid, PageExhausted):
                        raise npid  # the table is untouched for this block
                    self.table[slot, blk] = npid
                    self._owned[slot] += 1
                elif self.pages.refcount[pid] > 1:
                    npid = self._alloc_page()
                    if isinstance(npid, PageExhausted):
                        raise npid  # no copy started for this block
                    srcs.append(pid)
                    dsts.append(npid)
                    self.pages.decref(pid)  # shared: cannot reach 0 here
                    self.table[slot, blk] = npid
                    self.cow_copies += 1
        finally:
            # the blocks already repointed get their copies, on the
            # exhaustion path too: the table never points at garbage
            if srcs:
                self._copy_pages(srcs, dsts)

    # -- lifecycle -----------------------------------------------------------
    def admit(self, slot: int, req_cache: dict, *, rid: int, pos: int, budget: int,
              first_tok: int, emitted: int = 1, prompt=None) -> None:
        """Place a prefilled batch-1 request cache (not grown: its sequence
        leaves hold ``pos`` rows) into a free slot, on fresh pages."""
        if pos < 1:
            raise ValueError(f"pos {pos} < 1")
        self._check_fits(pos, budget, emitted)
        self._claim(slot)
        nb = self._blocks_for(pos)
        pids = self._alloc_pages(nb)
        if isinstance(pids, PageExhausted):
            self.active[slot] = False  # unwind the claim
            self.slots[slot] = SlotInfo()
            self._free.appendleft(slot)
            raise pids
        self.table[slot, :] = SCRATCH
        self.table[slot, :nb] = pids
        self._owned[slot] = nb
        self._resv[slot] = self._blocks_for(pos + budget - emitted)
        self._admit_rows(req_cache, slot, pids)
        self.slots[slot] = SlotInfo(rid=rid, pos=pos, budget=budget, emitted=emitted)
        self.tok[slot] = first_tok
        if prompt is not None and self.share_prefix:
            self._register_prompt(slot, np.asarray(prompt, np.int32))

    def reserve(self, slot: int, *, rid: int, s0: int = 0, budget: int = 0,
                shared_len: int = 0) -> None:
        super().reserve(slot, rid=rid)
        if s0:
            # the worst case net of the shared prefix (its pages come from the
            # registry): can_admit sees it at once, so a group reserves member
            # by member
            self._resv[slot] = self._blocks_for(s0 + budget - 1) - shared_len // self.page
            self._owned[slot] = 0

    def activate_from_group(self, slot: int, group_cache: dict, j: int, *, rid: int, pos: int,
                            budget: int, first_tok: int, prompt=None, pins=()) -> None:
        """The paged ``activate``: map the shared prefix pages (the group's
        pins pass to the table), allocate and store the delta blocks from
        row ``j`` of the group cache, register the prompt."""
        if not (self.active[slot] and self.admitting[slot]):
            raise ValueError(f"slot {slot} not admitting")
        if self.slots[slot].rid != rid:
            raise ValueError(f"slot {slot} holds request {self.slots[slot].rid}, not {rid}")
        if pos + budget > self.max_len or budget < 1:
            raise ValueError(f"request does not fit: pos {pos}, budget {budget}, "
                             f"max_len {self.max_len}")
        bs, nb = len(pins), self._blocks_for(pos)
        if bs >= nb:
            raise ValueError(f"{bs} shared blocks of {nb}: the last prompt position is never "
                             "shared")
        delta = self._alloc_pages(nb - bs)
        if isinstance(delta, PageExhausted):
            raise delta  # the slot stays admitting; the group cancels as a whole
        self.table[slot, :] = SCRATCH
        self.table[slot, :bs] = pins
        self.table[slot, bs:nb] = delta
        self._owned[slot] = nb
        self._resv[slot] = self._blocks_for(pos + budget - 1)
        self._activate_rows(group_cache, slot, j, delta, bs, nb)
        self.slots[slot] = SlotInfo(rid=rid, pos=pos, budget=budget, emitted=1)
        self.admitting[slot] = False
        self.tok[slot] = first_tok
        if prompt is not None and self.share_prefix:
            self._register_prompt(slot, np.asarray(prompt, np.int32))

    def fill_group_prefix(self, group_cache: dict, pins: list[list[int]]) -> dict:
        """Gather each group member's pinned prefix pages into the leading
        rows of the group's contiguous prefill cache, in place; returns it."""
        tables = torch.as_tensor(np.asarray(pins, np.int64), device=self.device)
        for key in self._pkeys:
            g = self.cache[key][:, tables]  # (lead, k, bs, page, *tail)
            if self.kv_quant:
                g = dequantize_kv(g, self.cache[f"{key}_scale"][:, tables])
            rows = g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3], *g.shape[4:])
            gc = group_cache[key]
            gc[:, :, :rows.shape[2]] = rows.to(gc.dtype)
        return group_cache

    def fork_slot(self, src: int, dst: int, *, rid: int) -> None:
        """Parallel-sampling fork: ``dst`` shares every page of ``src``
        copy-on-write (table row copied, pages referenced once more); the
        unpaged rows are copied.  Either side's next write to a shared block
        copies it first (``ensure_writable``)."""
        if not self.active[src] or self.admitting[src]:
            raise ValueError(f"slot {src} is not decoding")
        self._claim(dst)
        self.table[dst] = self.table[src]
        for pid in self.table[dst]:
            if pid != SCRATCH:
                self.pages.incref(int(pid))
        self._owned[dst] = self._owned[src]
        self._resv[dst] = self._resv[src]
        info = self.slots[src]
        self.slots[dst] = SlotInfo(rid=rid, pos=info.pos, budget=info.budget,
                                   emitted=info.emitted)
        self.tok[dst] = self.tok[src]
        for _, leaf in self._unpaged():
            leaf[:, dst] = leaf[:, src]

    def poison(self, slot: int) -> None:
        """Fault injection: NaN the slot's cache.  Shared pages (registry,
        forks) are copied first and only the copies corrupted, so sharers
        and the registry keep their bytes.  The slot is marked tainted: its
        pages are zeroed when allocated again and its unpaged rows at
        retire, so a recycled NaN never reaches another slot's value product
        (a masked weight is exactly 0.0, but 0.0 * NaN = NaN).  int8 payloads
        cannot hold a NaN; their scales do, and the gather's q * NaN poisons
        every value they cover."""
        if not self.active[slot] or self.admitting[slot]:
            raise ValueError(f"slot {slot} is not decoding")
        srcs, dsts = [], []
        for blk in range(self.max_blocks):
            pid = int(self.table[slot, blk])
            if pid != SCRATCH and self.pages.refcount[pid] > 1:
                npid = self._alloc_page()
                if isinstance(npid, PageExhausted):
                    # this block stays shared and clean; the slot's own pages
                    # and rows still get the NaNs, so the fault is detected
                    continue
                srcs.append(pid)
                dsts.append(npid)
                self.pages.decref(pid)
                self.table[slot, blk] = npid
                self.cow_copies += 1
        if srcs:
            self._copy_pages(srcs, dsts)
        # only pages the slot owns alone: a block whose copy was skipped is
        # still shared and keeps its bytes
        ids = _ids([int(p) for p in self.table[slot]
                    if p != SCRATCH and self.pages.refcount[int(p)] == 1], self.device)
        for key, leaf in self.cache.items():
            if not leaf.is_floating_point():
                continue
            if key in self._pleaves:
                leaf.index_fill_(1, ids, float("nan"))
            else:
                leaf[:, slot] = float("nan")
        self._slot_tainted.add(slot)

    def scrub_scratch(self) -> None:
        """Zero the scratch page.  The engine calls this after a tick whose
        finiteness guard fired: a poisoned slot's redirected writes may have
        parked NaNs there, and every slot's unmapped blocks gather it."""
        if self._pleaves:
            self._zero_pages([SCRATCH])

    def retire(self, slot: int) -> None:
        tainted = slot in self._slot_tainted
        for pid in self.table[slot]:
            pid = int(pid)
            if pid == SCRATCH:
                continue
            if self.pages.decref(pid) and tainted:
                self._tainted.add(pid)
        if tainted:
            self._slot_tainted.discard(slot)
            for _, leaf in self._unpaged():
                leaf[:, slot] = 0
        self.table[slot, :] = SCRATCH
        self._owned[slot] = 0
        self._resv[slot] = 0
        super().retire(slot)

    # -- preemption: swap out, swap in ---------------------------------------
    def swap_image_bytes(self, slot: int) -> int:
        """Host bytes a ``swap_out`` of ``slot`` would take, known before the
        image is built (the scheduler's swap-or-recompute input)."""
        nb = self._blocks_for(self.slots[slot].pos)
        page_b = sum(self.cache[k].nbytes // self.num_pages for k in self._pleaves)
        row_b = sum(v.nbytes // self.max_batch for _, v in self._unpaged())
        return nb * page_b + row_b

    def swap_out(self, slot: int) -> dict:
        """Preempt ``slot``: copy the pages of positions [0, pos) and its
        unpaged rows (the whole state of the ssm family) to host tensors,
        with the bookkeeping to continue, then release the slot.  Verify
        tail blocks past ``pos`` held rejected drafts only and are dropped.
        ``swap_in`` restores it bit for bit."""
        if not self.active[slot] or self.admitting[slot]:
            raise ValueError(f"slot {slot} is not decoding")
        if slot in self._slot_tainted:
            raise ValueError(f"slot {slot} is poisoned and cannot be swapped")
        info = self.slots[slot]
        nb = self._blocks_for(info.pos)
        pids = [int(self.table[slot, b]) for b in range(nb)]
        assert SCRATCH not in pids, (slot, pids)
        ids = _ids(pids, self.device)
        # host copies: ``.cpu()`` of a CPU pool's row would be a view of it,
        # which the slot's next tenant overwrites
        pages = {k: self.cache[k].index_select(1, ids).to("cpu", copy=True)
                 for k in self._pleaves}
        row = {k: v[:, slot:slot + 1].to("cpu", copy=True) for k, v in self._unpaged()}
        image = {
            "rid": info.rid, "pos": info.pos, "budget": info.budget, "emitted": info.emitted,
            "tier": info.tier, "tok": int(self.tok[slot]), "resv": int(self._resv[slot]),
            "pages": pages, "row": row,
            "bytes": sum(t.nbytes for t in (*pages.values(), *row.values())),
        }
        self.swap_outs += 1
        self.swapped_bytes += image["bytes"]
        self.retire(slot)
        return image

    def swap_in(self, slot: int, image: dict) -> None:
        """Restore a ``swap_out`` image into a free slot on fresh pages;
        raises ``PageExhausted`` after a clean unwind when the pool cannot
        supply its blocks (the image stays valid)."""
        nb = self._blocks_for(image["pos"])
        self._claim(slot)
        pids = self._alloc_pages(nb)
        if isinstance(pids, PageExhausted):
            self.active[slot] = False
            self._free.appendleft(slot)
            raise pids
        self.table[slot, :] = SCRATCH
        self.table[slot, :nb] = pids
        self._owned[slot] = nb
        self._resv[slot] = image["resv"]
        ids = _ids(pids, self.device)
        for key, leaf in self.cache.items():
            if key in self._pleaves:
                leaf.index_copy_(1, ids, image["pages"][key].to(leaf.device, leaf.dtype))
            else:
                leaf[:, slot] = image["row"][key][:, 0].to(leaf.device, leaf.dtype)
        self.slots[slot] = SlotInfo(rid=image["rid"], pos=image["pos"], budget=image["budget"],
                                    emitted=image["emitted"], tier=image["tier"])
        self.tok[slot] = image["tok"]
        self.swap_ins += 1

    # -- invariants ----------------------------------------------------------
    def check_invariants(self) -> None:
        """Refcount conservation: each page's refcount is its table mappings
        plus its registry entry (plus test pins in ``_extra_pins`` and
        page-pressure pins); the free pages are exactly those at 0, each
        listed once."""
        refs = np.zeros(self.num_pages, np.int64)
        refs[SCRATCH] = 1
        for pid in self.table.ravel():
            if pid != SCRATCH:
                refs[pid] += 1
        for pid in self._prefix.values():
            refs[pid] += 1
        for pid in getattr(self, "_extra_pins", ()):
            refs[pid] += 1
        for pid in self._press_pins:
            refs[pid] += 1
        assert (refs == self.pages.refcount).all(), (refs.tolist(),
                                                     self.pages.refcount.tolist())
        free = sorted(self.pages._free)
        assert len(free) == len(set(free)), "duplicate free-list entry"
        assert free == [int(p) for p in np.flatnonzero(refs == 0)], (
            free, np.flatnonzero(refs == 0).tolist())
