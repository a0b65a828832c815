"""Per-slot draft-token proposers for self-speculative decoding.

The serving-side half of speculative decode: a drafter proposes K candidate
next tokens per decoding request, the engine scores all K+1 positions in one
``masked_speculative_step``, and greedy acceptance commits the matching
prefix. The drafter needs no extra model weights — it exploits APPLICATION
knowledge of the workload (the paper's core move, recast at the token
level): served generations are locally repetitive, so a suffix match over
the request's OWN context (prompt + tokens emitted so far) is a strong
predictor of the next few tokens ("prompt-lookup" drafting).

Wrong drafts only cost the per-candidate verify increment: acceptance is
exact greedy match, so a drafter can never change emitted tokens, and the
accept-0 worst case still commits one token per tick like plain decode.
"""
from __future__ import annotations

import numpy as np


class NgramDrafter:
    """Suffix-cache drafter over each request's own token history.

    For a request whose context ends in some n-gram, find that n-gram's most
    recent PREVIOUS occurrence in the context (longest n first) and replay
    the tokens that followed it. Falls back to repeating the last token —
    the period-1 guess — when no suffix recurs.

    Lookup is an incremental index, not a scan: ``observe`` registers each
    new n-gram's continuation position as tokens append (keeping the latest
    two occurrences — at most one of them can be the current suffix itself),
    so ``propose`` is O(max_ngram) per tick regardless of history length and
    the host-side drafting never competes with the device step.

    Histories are keyed by request id (slots are recycled); ``forget`` drops
    a finished request's history so memory stays bounded by the pool.
    """

    def __init__(self, k: int, *, max_ngram: int = 4, min_ngram: int = 1,
                 max_history: int = 1024):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_history = max_history
        self._hist: dict[int, list[int]] = {}
        # per rid: n-gram tuple -> (latest, previous) continuation positions
        self._idx: dict[int, dict[tuple, tuple[int, int | None]]] = {}

    def begin(self, rid: int, context) -> None:
        """Start a request's history (prompt tokens + its first emitted
        token, i.e. everything resident in its cache plus the pending
        next decode input)."""
        self._hist[rid] = []
        self._idx[rid] = {}
        self.observe(rid, context)

    def observe(self, rid: int, tokens) -> None:
        """Fold a tick's committed tokens into the request's history."""
        h = self._hist[rid]
        idx = self._idx[rid]
        for t in tokens:
            h.append(int(t))
            self._register(h, len(h), idx)
        if len(h) > self.max_history:
            # trim in half-window blocks so the index rebuild (positions
            # shifted) is amortized O(1) per token, not per tick
            del h[: len(h) - self.max_history // 2]
            idx.clear()
            for end in range(1, len(h) + 1):
                self._register(h, end, idx)

    def _register(self, h: list[int], end: int, idx: dict) -> None:
        """Index the n-grams ending just before ``end``: their continuation
        starts at ``end`` (for the newest position that continuation is
        unknown yet — at propose time an entry equal to the history length
        IS the current suffix and is skipped in favour of the previous
        occurrence)."""
        for n in range(self.min_ngram, self.max_ngram + 1):
            if n > end:
                break
            gram = tuple(h[end - n : end])
            prev = idx.get(gram)
            idx[gram] = (end, prev[0] if prev else None)

    def forget(self, rid: int) -> None:
        self._hist.pop(rid, None)
        self._idx.pop(rid, None)

    def propose(self, rid: int) -> np.ndarray:
        """(k,) int32 draft tokens for the request's next verify window."""
        h = self._hist.get(rid)
        if not h:
            return np.zeros(self.k, np.int32)
        out = self._suffix_match(h, self._idx[rid])
        if out is None:
            out = [h[-1]] * self.k  # period-1 fallback
        return np.asarray(out, np.int32)

    def _suffix_match(self, h: list[int], idx: dict) -> list[int] | None:
        for n in range(min(self.max_ngram, len(h) - 1), self.min_ngram - 1, -1):
            e = idx.get(tuple(h[-n:]))
            if e is None:
                continue
            # most recent occurrence that is not the suffix itself (i.e.
            # whose continuation lies strictly inside the history)
            cont = e[0] if e[0] < len(h) else e[1]
            if cont is None or cont >= len(h):
                continue
            out = h[cont : cont + self.k]
            while len(out) < self.k:  # ran into the history's end
                out.append(out[-1])
            return out
        return None


class SpecThrottle:
    """Per-request speculation auto-throttle: graceful degradation when
    drafting stops paying.

    Speculation is a bet — each tick verifies k extra positions, and an
    acceptance stall (a request whose output stopped being locally
    repetitive) turns the whole window into wasted verify energy. The
    throttle tracks an acceptance-rate EMA per request and HALVES the
    request's draft window each time the EMA falls below ``lo``; windows
    regrow by doubling once the EMA recovers above ``hi``. A throttled-to-0
    request periodically probes with a 1-draft window (every
    ``probe_every`` ticks) so a request whose output turns repetitive again
    can re-earn its window.

    The hysteresis band (lo < hi) keeps the window from flapping, and
    windows move in powers of two so the engine's verify tick, one captured
    graph per K, sees at most log2(k_max) distinct windows. State is keyed
    by rid like the drafter; ``forget`` drops finished requests.
    """

    def __init__(self, k_max: int, *, lo: float = 0.2, hi: float = 0.5,
                 alpha: float = 0.3, probe_every: int = 8):
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError(f"need 0 <= lo < hi <= 1, got lo={lo} hi={hi}")
        self.k_max = k_max
        self.lo = lo
        self.hi = hi
        self.alpha = alpha
        self.probe_every = probe_every
        self._k: dict[int, int] = {}       # current window per rid
        self._ema: dict[int, float] = {}   # acceptance-rate EMA per rid
        self._idle: dict[int, int] = {}    # ticks spent throttled-to-0

    @staticmethod
    def halved(k: int, steps: int) -> int:
        """Window after ``steps`` of the same halvings ``observe`` applies
        on an acceptance stall. Shared with the brownout governor
        (``serving/brownout.py``) so a power-degraded window walks the
        identical ladder — and the identical verify graphs — a
        throttled window walks."""
        for _ in range(max(steps, 0)):
            k //= 2
        return k

    def begin(self, rid: int) -> None:
        self._k[rid] = self.k_max
        self._ema[rid] = 1.0  # optimistic start: earn the full window
        self._idle[rid] = 0

    def forget(self, rid: int) -> None:
        self._k.pop(rid, None)
        self._ema.pop(rid, None)
        self._idle.pop(rid, None)

    def window(self, rid: int) -> int:
        """Draft tokens this request should field this tick, in [0, k_max].
        0 means the request is plain-decode until its next probe."""
        k = self._k.get(rid, self.k_max)
        if k == 0:
            self._idle[rid] = self._idle.get(rid, 0) + 1
            if self._idle[rid] >= self.probe_every:
                self._idle[rid] = 0
                return 1  # probe tick: one draft, cheap re-test
        return k

    def observe(self, rid: int, accepted: int, fielded: int) -> None:
        """Fold one verify tick's outcome in: ``accepted`` of ``fielded``
        drafts matched. No-op for plain-decode ticks (fielded == 0)."""
        if fielded <= 0:
            return
        rate = accepted / fielded
        ema = self._ema.get(rid, 1.0)
        ema = (1 - self.alpha) * ema + self.alpha * rate
        self._ema[rid] = ema
        k = self._k.get(rid, self.k_max)
        if ema < self.lo:
            self._k[rid] = k // 2  # halve; 1 -> 0 disables until probe
            self._ema[rid] = (self.lo + self.hi) / 2  # re-center after the cut
        elif ema > self.hi and 0 < k < self.k_max:
            self._k[rid] = min(2 * k, self.k_max)
        elif ema > self.hi and k == 0:
            # a successful probe re-opens the smallest window
            self._k[rid] = 1
