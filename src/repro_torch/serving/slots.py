"""Slot-pool decode state for continuous batching (the contiguous layout).

The cache from ``kv_cache.cache_defs`` becomes a fixed pool of ``max_batch``
slots sharing ONE device cache (batch axis 1 on every leaf).  Requests of
different prompt lengths and budgets are admitted into free slots mid-decode
and retired independently, so the engine runs one masked decode step over
the whole pool:

  * ``active`` / per-slot ``pos`` are host-side state; the device sees the
    full (max_batch,) vectors.
  * ``admit`` copies a prefilled per-request cache (grown to pool capacity
    with ``grow_cache``) into the slot's batch row, in place.
  * ``retire`` flips host-side bookkeeping only: a freed slot's rows are
    dead data, overwritten by the next ``admit`` (the masked decode step
    sends inactive slots to position 0, so their writes land in dead rows).

What only modules not yet ported use is left out until they come: virtual
pools, the free-slot queue, SLO tiers and the scheduler's views (ROADMAP
Queue A item 11), chunked admission (``reserve`` / ``activate``, item 9),
the paged pool (item 10).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import init_params
from repro_torch.serving.kv_cache import cache_defs


def grow_cache(cfg: ArchConfig, cache: dict, max_len: int) -> dict:
    """Pad prefill-produced sequence-axis caches out to ``max_len`` rows."""

    def grow(x, axis):
        pad = max_len - x.shape[axis]
        if pad <= 0:
            return x
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=axis)

    f = cfg.family
    if f in ("dense", "vlm") or (f == "moe" and cfg.mla is None):
        return dict(cache, k=grow(cache["k"], 2), v=grow(cache["v"], 2))
    raise NotImplementedError(f"growing the {f!r} cache is not ported yet "
                              "(ROADMAP Queue A item 8)")


@dataclasses.dataclass
class SlotInfo:
    """Host-side bookkeeping for one slot."""

    rid: int | None = None
    pos: int = 0      # next cache position to write (== tokens resident)
    budget: int = 0   # total new tokens this request will emit
    emitted: int = 0  # tokens emitted so far (prefill's argmax counts as #1)


class SlotPool:
    """Fixed pool of decode slots over one shared device cache.

    ``slack`` adds dead cache rows past ``max_len`` (for speculative verify
    windows); the admission bound stays ``max_len``.
    """

    def __init__(self, cfg: ArchConfig, *, max_batch: int, max_len: int, slack: int = 0,
                 device=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.slack = slack
        self.capacity = max_len + slack
        self.cache = init_params(
            cache_defs(cfg, batch=max_batch, max_len=self.capacity), torch.Generator(), device)
        self.committed = 0  # tokens committed through ``advance``
        self.slots = [SlotInfo() for _ in range(max_batch)]
        self.active = np.zeros(max_batch, bool)
        self.tok = np.zeros(max_batch, np.int32)  # next decode input per slot

    def decode_mask(self) -> np.ndarray:
        """Slots the masked decode step should advance."""
        return self.active.copy()

    def positions(self) -> np.ndarray:
        return np.asarray([s.pos for s in self.slots], np.int32)

    def admit(self, slot: int, req_cache: dict, *, rid: int, pos: int,
              budget: int, first_tok: int, emitted: int = 1, prompt=None) -> None:
        """Place a prefilled request (cache grown to capacity) into a free slot:
        its rows of the pool's cache are overwritten in place."""
        if pos + (budget - emitted) + 1 > self.max_len or not 1 <= emitted <= budget:
            raise ValueError(f"request does not fit: pos {pos}, budget {budget}, "
                             f"emitted {emitted}, max_len {self.max_len}")
        if self.active[slot]:
            raise ValueError(f"slot {slot} already active")
        self.active[slot] = True
        for key, pool_leaf in self.cache.items():
            pool_leaf[:, slot] = req_cache[key][:, 0].to(pool_leaf.dtype)
        self.slots[slot] = SlotInfo(rid=rid, pos=pos, budget=budget, emitted=emitted)
        self.tok[slot] = first_tok

    def advance(self, slot: int, n: int, next_tok: int) -> None:
        """Commit ``n`` emitted tokens to a decoding slot."""
        if n < 1 or not self.active[slot]:
            raise ValueError(f"slot {slot}: cannot advance by {n}")
        info = self.slots[slot]
        info.pos += n
        info.emitted += n
        self.tok[slot] = next_tok
        self.committed += n

    def retire(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} not active")
        self.active[slot] = False
        self.slots[slot] = SlotInfo()
