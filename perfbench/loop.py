"""The benchmark's serving loop on the wall clock.

It copies the policy of the port's scheduler (``serving/scheduler.py``,
commit d0d3ca4) in its ``continuous`` and ``chunked`` modes, with time read
from the host clock instead of a calibrated virtual clock:

* admission is FIFO into free slots between decode ticks;
* ``blocking``: every waiting request that finds a free slot is prefilled
  (``prefill_into_slot``) before the next tick, each prefill stalling the
  whole pool;
* ``chunked``: one group at a time, the maximal FIFO run of waiting
  requests with the same prompt length, one chunk of ``chunk_tokens``
  between ticks (``begin_chunked_prefill`` / ``chunked_prefill_step`` /
  ``finish_chunked_prefill``);
* one ``masked_decode_step`` (the replayed CUDA graph) a loop iteration
  while any slot decodes; each decoding slot advances by its token and
  retires at its budget; a slot whose logits the finite flag refuses is
  retired and its request counted as failed.

Arrivals come from the traffic file: an open loop's requests are due on a
schedule whatever the pool does; a closed loop's clients each send their
next request when the last one finishes.  Every token is stamped with the
host time at which the host holds it (the engine's calls return host
integers, so each stamp follows a synchronisation).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np

from perfbench.traffic import Request, primed_budget


@dataclasses.dataclass
class Record:
    """One request as served."""

    req: Request
    due: float                      # host time it was due (open) or sent (closed)
    started: float | None = None    # host time its admission began
    tokens: list = dataclasses.field(default_factory=list)
    times: list = dataclasses.field(default_factory=list)
    done: bool = False
    failed: bool = False
    budget: int = 0                 # tokens it emits (a primed request's are fewer)


@dataclasses.dataclass
class Work:
    """One unit of device work, for the counts of operations and bytes."""

    kind: str            # "prefill" | "chunk" | "tick"
    t0: float
    t1: float
    args: dict


class Spans:
    """Host-clock spans of the loop's layers (admission, prefill, chunk,
    tick, bookkeeping), and ``torch.profiler`` annotations of the same
    names while a profiler records (``annotate``)."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.annotate:
            import torch

            cm = torch.profiler.record_function(f"pb.{name}")
        else:
            cm = contextlib.nullcontext()
        t0 = time.perf_counter()
        with cm:
            yield
        self.items.append((name, t0, time.perf_counter()))


class ServeLoop:
    """Drives ``eng`` on ``pool`` with the traffic's requests.

    ``start(t0)`` fixes the window's start on the host clock: an open
    loop's arrivals are taken relative to it (its ramp's are before it).
    ``run_until(t)`` serves until the host clock reaches ``t``;
    ``hook(now)``, when given, is called between iterations (the traced
    run's profiler)."""

    def __init__(self, eng, pool, traffic: dict, requests: list[Request], *, sync=None):
        self.eng, self.pool, self.traffic = eng, pool, traffic
        self.reqs = requests
        self.sync = sync or (lambda: None)
        self.mode = traffic["admission"]["mode"]
        if self.mode not in ("blocking", "chunked"):
            raise ValueError(f"unknown admission mode {self.mode!r}")
        self.chunk = int(traffic["admission"].get("chunk_tokens", 0))
        self.records: dict[int, Record] = {}
        self.work: list[Work] = []
        self.spans = Spans()
        self.ready: collections.deque[Record] = collections.deque()
        self.next_req = 0          # next request of the list not yet sent
        self.slot_rec: dict[int, Record] = {}
        self.group = None
        self.group_recs: list[Record] = []
        self.t0: float | None = None
        self.errors: list[str] = []

    # -- arrivals -----------------------------------------------------------
    def start(self, t0: float) -> None:
        self.t0 = t0

    def _send(self, now: float, budget: int | None = None) -> None:
        """Hand the next request of the list to the ready queue."""
        r = self.reqs[self.next_req]
        self.next_req += 1
        due = now if r.arrival_s is None else self.t0 + r.arrival_s
        rec = Record(req=r, due=due, budget=budget or r.new_tokens)
        self.records[r.rid] = rec
        self.ready.append(rec)

    def _ingest(self, now: float) -> None:
        if self.traffic["loop"] != "open":
            return
        while self.next_req < len(self.reqs) and self.t0 + self.reqs[self.next_req].arrival_s <= now:
            self._send(now)

    def next_due(self) -> float | None:
        if self.traffic["loop"] != "open" or self.next_req >= len(self.reqs):
            return None
        return self.t0 + self.reqs[self.next_req].arrival_s

    def open_clients(self, now: float, primed: int) -> None:
        """A closed loop's clients each send their first request; the first
        ``primed`` of them stand at staggered points of their answers, the
        fractions dealt out by the rank of their lengths, so that the same
        set of requests (``traffic``'s block permutation) primes the same
        work whatever the seed."""
        first = self.reqs[self.next_req:self.next_req + primed]
        rank = {r.rid: i for i, r in enumerate(sorted(
            first, key=lambda r: (r.new_tokens, len(r.prompt), r.rid)))}
        for j in range(int(self.traffic["clients"])):
            r = self.reqs[self.next_req]
            self._send(now, primed_budget(self.traffic, rank[r.rid], primed, r.new_tokens)
                       if j < primed else None)

    def _finished(self, rec: Record, now: float) -> None:
        rec.done = True
        if self.traffic["loop"] == "closed" and self.next_req < len(self.reqs):
            self._send(now)

    # -- one iteration ------------------------------------------------------
    def _emit(self, rec: Record, tok: int, now: float) -> None:
        rec.tokens.append(int(tok))
        rec.times.append(now)

    def _admit_blocking(self) -> None:
        pool = self.pool
        while self.ready and pool.free_count:
            rec = self.ready.popleft()
            slot = pool.next_free()
            rec.started = time.perf_counter()
            s0 = len(rec.req.prompt)
            try:
                with self.spans("prefill"):
                    first = self.eng.prefill_into_slot(pool, slot, rec.req.prompt,
                                                       rid=rec.req.rid, budget=rec.budget)
            except (RuntimeError, ValueError) as e:
                rec.failed = True
                self.errors.append(f"request {rec.req.rid}: {e}")
                if pool.active[slot]:
                    pool.retire(slot)
                continue
            now = time.perf_counter()
            self.work.append(Work("prefill", rec.started, now, {"tokens": s0}))
            self._emit(rec, first, now)
            if rec.budget == 1:
                pool.retire(slot)
                self._finished(rec, now)
            else:
                self.slot_rec[slot] = rec
            self._ingest(now)

    def _admit_chunked(self) -> None:
        pool = self.pool
        if self.group is None and self.ready and pool.free_count:
            recs = [self.ready.popleft()]
            s0 = len(recs[0].req.prompt)
            while self.ready and len(recs) < pool.free_count and len(self.ready[0].req.prompt) == s0:
                recs.append(self.ready.popleft())
            slots = pool.free_slots()[: len(recs)]
            now = time.perf_counter()
            for rec in recs:
                rec.started = now
            with self.spans("admission"):
                self.group = self.eng.begin_chunked_prefill(
                    pool, slots, np.stack([r.req.prompt for r in recs]),
                    rids=[r.req.rid for r in recs], budgets=[r.budget for r in recs])
            self.group_recs = recs
        if self.group is None:
            return
        st = self.group
        t0, pos = time.perf_counter(), st.pos
        with self.spans("chunk"):
            took = self.eng.chunked_prefill_step(st, self.chunk)
            self.sync()
        now = time.perf_counter()
        self.work.append(Work("chunk", t0, now, {"rows": len(self.group_recs), "pos": pos,
                                                 "tokens": took, "last": st.done}))
        if not st.done:
            return
        with self.spans("admission"):
            firsts = self.eng.finish_chunked_prefill(pool, st)
        now = time.perf_counter()
        for slot, rec, tok in zip(st.slots, self.group_recs, firsts):
            self._emit(rec, tok, now)
            if rec.budget == 1:
                pool.retire(slot)
                self._finished(rec, now)
            else:
                self.slot_rec[slot] = rec
        self.group, self.group_recs = None, []

    def _tick(self) -> None:
        pool = self.pool
        live = pool.decoding_slots()
        positions = [pool.slots[s].pos for s in live]
        t0 = time.perf_counter()
        with self.spans("tick"):
            nxt, fin = self.eng.masked_decode_step(pool)
        now = time.perf_counter()
        self.work.append(Work("tick", t0, now, {"positions": positions}))
        with self.spans("bookkeeping"):
            for s in live:
                rec = self.slot_rec[s]
                if not fin[s]:
                    rec.failed = True
                    pool.retire(s)
                    del self.slot_rec[s]
                    self._finished(rec, now)
                    continue
                pool.advance(s, 1, int(nxt[s]))
                self._emit(rec, nxt[s], now)
                if pool.slots[s].emitted >= rec.budget:
                    pool.retire(s)
                    del self.slot_rec[s]
                    self._finished(rec, now)

    def iteration(self) -> bool:
        """One pass: arrivals, admission, one tick.  False when there was
        nothing to do."""
        now = time.perf_counter()
        self._ingest(now)
        busy = bool(self.ready) or self.group is not None
        if self.mode == "blocking":
            self._admit_blocking()
        else:
            self._admit_chunked()
        if self.pool.decoding_count:
            self._tick()
            busy = True
        return busy

    def run_until(self, t_end: float, hook=None) -> None:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            if hook is not None:
                hook(now)
            if not self.iteration():
                due = self.next_due()
                wait = (t_end if due is None else min(due, t_end)) - time.perf_counter()
                if wait > 0:
                    time.sleep(min(wait, 0.01))

    def prime(self, primed: int) -> None:
        """Set-up of a closed loop: the clients' first requests, the first
        ``primed`` of them (as many as the pool has slots) admitted before
        the window, without ticks between them."""
        self.open_clients(time.perf_counter(), primed)
        while sum(1 for r in self.records.values() if r.tokens) < primed:
            if self.mode == "blocking":
                self._admit_blocking()
            else:
                self._admit_chunked()
