"""Slot-pool decode state for continuous batching (the contiguous layout).

The cache from ``kv_cache.cache_defs`` becomes a fixed pool of ``max_batch``
slots sharing ONE device cache (batch axis 1 on every leaf).  Requests of
different prompt lengths and budgets are admitted into free slots mid-decode
and retired independently, so the engine runs one masked decode step over
the whole pool:

  * ``active`` / ``admitting`` / per-slot ``pos`` are host-side state; the
    device sees the full (max_batch,) vectors.
  * ``admit`` copies a prefilled per-request cache (grown to pool capacity
    with ``grow_cache``) into the slot's batch row, in place.
  * chunked admission reserves slots up front (``reserve`` → ``admitting``,
    excluded from the decode mask) and lands the prefilled cache with
    ``activate`` once the group's last chunk is done.
  * ``retire`` flips host-side bookkeeping only: a freed slot's rows are
    dead data, overwritten by the next ``admit`` (the masked decode step
    sends inactive slots to position 0, so their writes land in dead rows).
  * a FIFO free list gives O(1) admission and FIFO slot reuse.

Every write to ``cache`` is in place and ``cache`` is never rebound: the
engine's captured decode and verify graphs (``serving/graphs.py``) hold the
addresses of its tensors.

A virtual pool (``virtual=True``) allocates no cache: it keeps the host-side
bookkeeping only, for the paged pool (``serving/pages.py``), which builds a
cache of its own on top, and for engine-free scheduler studies
(``admit_virtual``).  ``SlotInfo.tier`` is the SLO tier the scheduler
(``serving/scheduler.py``) reads; the paged pool's swap images carry it.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.params import init_params
from repro_torch.serving.kv_cache import cache_defs, paged_keys


def grow_cache(cfg: ArchConfig, cache: dict, max_len: int) -> dict:
    """Pad prefill-produced sequence-axis caches out to ``max_len`` rows:
    K/V, MLA's c/k_rope, hybrid's shared K/V.  The ssm conv/state leaves
    and whisper's cross K/V (fixed at encoder_seq) are O(1) in the sequence
    and pass through as they are."""

    def grow(x, axis):
        pad = max_len - x.shape[axis]
        if pad <= 0:
            return x
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=axis)

    seq = paged_keys(cfg)  # the leaves with a sequence axis
    return {key: grow(t, 2) if key in seq else t for key, t in cache.items()}


@dataclasses.dataclass
class SlotInfo:
    """Host-side bookkeeping for one slot."""

    rid: int | None = None
    pos: int = 0      # next cache position to write (== tokens resident)
    budget: int = 0   # total new tokens this request will emit
    emitted: int = 0  # tokens emitted so far (prefill's argmax counts as #1)
    tier: str = "batch"  # SLO tier: "latency" may preempt "batch" slots


class SlotPool:
    """Fixed pool of decode slots over one shared device cache.

    ``slack`` adds dead cache rows past ``max_len``: a speculative verify
    window of K+1 tokens may start as late as position max_len-2, and its
    tail writes need rows of their own.  The admission bound stays
    ``max_len``; slack rows only ever hold rejected candidates.
    """

    def __init__(self, cfg: ArchConfig, *, max_batch: int, max_len: int, slack: int = 0,
                 virtual: bool = False, device=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.slack = slack
        self.capacity = max_len + slack
        self.device = resolve_device(device)
        self.cache = None if virtual else init_params(
            cache_defs(cfg, batch=max_batch, max_len=self.capacity), torch.Generator(),
            self.device)
        # tokens committed through ``advance`` (every decode/verify tick), and
        # how many of them were drafted (0 under plain decode)
        self.committed = 0
        self.drafted = 0
        self.slots = [SlotInfo() for _ in range(max_batch)]
        self.active = np.zeros(max_batch, bool)     # slot occupied at all
        self.admitting = np.zeros(max_batch, bool)  # reserved, prefill in flight
        self.tok = np.zeros(max_batch, np.int32)    # next decode input per slot
        self._free = collections.deque(range(max_batch))

    def _write(self, slot: int, req_cache: dict) -> None:
        for key, pool_leaf in self.cache.items():
            pool_leaf[:, slot] = req_cache[key][:, 0].to(pool_leaf.dtype)

    # -- host-side views ----------------------------------------------------
    @property
    def active_count(self) -> int:
        return int(self.active.sum())

    @property
    def free_count(self) -> int:
        return len(self._free)

    def next_free(self) -> int:
        """The next free slot (FIFO over retirements), not claimed."""
        return self._free[0]

    def free_slots(self) -> list[int]:
        return list(self._free)

    def active_slots(self) -> list[int]:
        return [i for i in range(self.max_batch) if self.active[i]]

    def decode_mask(self) -> np.ndarray:
        """Slots the masked decode step should advance: active and not still
        admitting (their prefill is in flight; their cache rows are dead)."""
        return self.active & ~self.admitting

    @property
    def decoding_count(self) -> int:
        return int(self.decode_mask().sum())

    def decoding_slots(self) -> list[int]:
        m = self.decode_mask()
        return [i for i in range(self.max_batch) if m[i]]

    def positions(self) -> np.ndarray:
        return np.asarray([s.pos for s in self.slots], np.int32)

    # -- lifecycle ----------------------------------------------------------
    def can_admit(self, s0: int, budget: int, *, shared_len: int = 0) -> bool:
        """Admission probe: a contiguous pool only needs a free slot (every
        slot owns its full cache rectangle)."""
        return self.free_count > 0

    def _claim(self, slot: int) -> None:
        if self.active[slot]:
            raise ValueError(f"slot {slot} already active")
        if self._free and self._free[0] == slot:
            self._free.popleft()  # O(1): callers claim the peeked FIFO head
        else:
            self._free.remove(slot)
        self.active[slot] = True

    def admit(self, slot: int, req_cache: dict, *, rid: int, pos: int,
              budget: int, first_tok: int, emitted: int = 1, prompt=None) -> None:
        """Place a prefilled request (cache grown to capacity) into a free slot:
        its rows of the pool's cache are overwritten in place.  ``first_tok``
        is the slot's next decode input (the prefill's argmax, or the last
        committed token of a resumed request, whose ``emitted`` then counts
        the tokens emitted before the fault)."""
        if self.cache is None:
            raise ValueError("cannot admit a cache into a virtual pool")
        self._check_fits(pos, budget, emitted)
        self._claim(slot)
        self._write(slot, req_cache)
        self.slots[slot] = SlotInfo(rid=rid, pos=pos, budget=budget, emitted=emitted)
        self.tok[slot] = first_tok

    def _check_fits(self, pos: int, budget: int, emitted: int) -> None:
        if pos + (budget - emitted) + 1 > self.max_len or not 1 <= emitted <= budget:
            raise ValueError(f"request does not fit: pos {pos}, budget {budget}, "
                             f"emitted {emitted}, max_len {self.max_len}")

    def admit_virtual(self, slot: int, *, rid: int, pos: int, budget: int,
                      emitted: int = 1) -> None:
        """Claim a slot with bookkeeping only (virtual pools, engine-free
        scheduler runs): no cache is written."""
        self._check_fits(pos, budget, emitted)
        self._claim(slot)
        self.slots[slot] = SlotInfo(rid=rid, pos=pos, budget=budget, emitted=emitted)

    def reserve(self, slot: int, *, rid: int, s0: int = 0, budget: int = 0,
                shared_len: int = 0) -> None:
        """Claim a free slot for a request whose chunked prefill is about to
        start: occupied, but ``admitting`` and out of the decode mask until
        ``activate``.  ``s0``, ``budget`` and ``shared_len`` are the paged
        pool's (its page reservation), unused here."""
        self._claim(slot)
        self.admitting[slot] = True
        self.slots[slot] = SlotInfo(rid=rid)

    def activate(self, slot: int, req_cache: dict, *, rid: int, pos: int,
                 budget: int, first_tok: int) -> None:
        """Flip a reserved slot from admitting to decoding once its chunked
        prefill is done; ``req_cache`` is the request's batch-1 cache."""
        if not (self.active[slot] and self.admitting[slot]):
            raise ValueError(f"slot {slot} not admitting")
        if self.slots[slot].rid != rid:
            raise ValueError(f"slot {slot} holds request {self.slots[slot].rid}, not {rid}")
        if pos + budget > self.max_len or budget < 1:
            raise ValueError(f"request does not fit: pos {pos}, budget {budget}, "
                             f"max_len {self.max_len}")
        if self.cache is not None:
            self._write(slot, req_cache)
        self.slots[slot] = SlotInfo(rid=rid, pos=pos, budget=budget, emitted=1)
        self.admitting[slot] = False
        self.tok[slot] = first_tok

    def advance(self, slot: int, n: int, next_tok: int) -> None:
        """Commit ``n`` emitted tokens to a decoding slot in one move (a verify
        tick's accepted drafts and bonus token; plain decode is n = 1);
        ``next_tok`` is the slot's new next decode input."""
        if n < 1 or not self.active[slot] or self.admitting[slot]:
            raise ValueError(f"slot {slot}: cannot advance by {n}")
        info = self.slots[slot]
        info.pos += n
        info.emitted += n
        self.tok[slot] = next_tok
        self.committed += n
        self.drafted += n - 1

    def retire(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} not active")
        self.active[slot] = False
        self.admitting[slot] = False
        self.slots[slot] = SlotInfo()
        self._free.append(slot)
