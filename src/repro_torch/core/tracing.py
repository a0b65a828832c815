"""The port's counters and spans: what the program did, counted where it
does it.

* **Counters** (``count(name, n)``) are integer adds, always counted:
  ``launch.<kernel>`` for each kernel launch (``kernels/runtime.py``),
  ``attn.decode_calls`` and ``attn.rows_scored`` for decode attention
  (``models/layers.py``; the B x Smax cache rows a call's mask spans),
  ``attn.rows_live`` for the rows of those that hold a live position
  (``serving/engine.py``; the only rows the decode kernel reads, so
  1 - rows_live / rows_scored is the share it skips), ``graph.kernels`` for the
  kernel nodes a replayed CUDA graph runs (``serving/graphs.py``).  A
  replayed graph adds every counter its capture moved
  (``serving/graphs.py``).
* **Spans** (``with span(name, **attrs):``) record a name, the start and
  end on ``time.perf_counter_ns()``, the enclosing open span (``parent``),
  the attributes (a request's ``rid``; children take their parent's
  ``rid`` or ``rids``), and the counters' deltas inside the span.  They
  are recorded only while tracing is on: while a torch profiler records in
  the process, or between :func:`start` and :func:`stop`.  Off, a span
  site checks one flag and gets a shared no-op.

Nothing here emits a profiler annotation: a ``record_function`` would come
back on the device's timeline spanning its kernels and read as device
work.  Spans share the profiler's clock through :func:`to_unix_ns`
instead: each time tracing turns on it stores a pair of readings
(``perf_counter_ns``, ``time_ns``), and the profiler stamps its events in
Unix-epoch nanoseconds.

Records are kept in memory, the newest :data:`CAPACITY` of them (each one
dropped counts ``tracing.dropped``), and read by :func:`spans`.  One
process, one host thread: the open spans are one stack.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16
REQUEST_KEYS = ("rid", "rids")


class SpanRecord:
    """One closed span; ``t0``, ``t1`` in ``perf_counter_ns``; ``parent``
    the ``id`` of the span open around it (None at the top)."""

    __slots__ = ("id", "name", "parent", "t0", "t1", "attrs", "counters")

    def __init__(self, id: int, name: str, parent: int | None, attrs: dict):
        self.id, self.name, self.parent, self.attrs = id, name, parent, attrs
        self.t0 = self.t1 = 0
        self.counters: dict[str, int] = {}

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{(self.t1 - self.t0) / 1e6:.3f} ms, {self.attrs}, {self.counters})")


class _State:
    def __init__(self):
        self.counters: dict[str, int] = {}
        self.started = False      # between start() and stop()
        self.on = False           # on at the last span site
        self.clock: tuple[int, int] | None = None  # (perf_counter_ns, time_ns)
        self.records: collections.deque[SpanRecord] = collections.deque(maxlen=CAPACITY)
        self.open: list[SpanRecord] = []
        self.paused = 0
        self.next_id = 0


_state = _State()
_OFF = contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------
def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    c = _state.counters
    c[name] = c.get(name, 0) + n


def counter(name: str) -> int:
    return _state.counters.get(name, 0)


def counters() -> dict[str, int]:
    """Every counter since the process started (or the last :func:`reset`)."""
    return dict(_state.counters)


def clear_counters(prefix: str) -> None:
    """Drop the counters whose names start with ``prefix``."""
    for name in [n for n in _state.counters if n.startswith(prefix)]:
        del _state.counters[name]


@contextlib.contextmanager
def paused():
    """Within, no span is recorded; counters count as ever (a CUDA graph's
    warm-up: its work runs, but its spans would be the step's inner ones,
    which no replay has)."""
    _state.paused += 1
    try:
        yield
    finally:
        _state.paused -= 1


@contextlib.contextmanager
def recorded():
    """Within, counters go to the dict this yields instead of the
    process's, and no span is recorded: work that runs nothing now (a CUDA
    graph's capture, which records what each replay adds)."""
    saved, _state.counters = _state.counters, {}
    try:
        with paused():
            yield _state.counters
    finally:
        _state.counters = saved


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------
def _clock_pair() -> tuple[int, int]:
    a = time.perf_counter_ns()
    unix = time.time_ns()
    return (a + time.perf_counter_ns()) // 2, unix


class _Span:
    __slots__ = ("rec", "before")

    def __init__(self, name: str, attrs: dict):
        st = _state
        parent = st.open[-1] if st.open else None
        if parent is not None:
            for key in REQUEST_KEYS:
                if key in parent.attrs and key not in attrs:
                    attrs[key] = parent.attrs[key]
        self.rec = SpanRecord(st.next_id, name, parent.id if parent else None, attrs)
        st.next_id += 1

    def __enter__(self) -> SpanRecord:
        self.before = dict(_state.counters)
        _state.open.append(self.rec)
        self.rec.t0 = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc) -> bool:
        rec, st = self.rec, _state
        rec.t1 = time.perf_counter_ns()
        st.open.remove(rec)
        before = self.before
        rec.counters = {k: v - before.get(k, 0) for k, v in st.counters.items()
                        if v != before.get(k, 0)}
        if len(st.records) == CAPACITY:
            count("tracing.dropped")
        st.records.append(rec)
        return False


def span(name: str, **attrs):
    """A context manager that records span ``name`` while tracing is on
    (module docstring), and does nothing otherwise."""
    st = _state
    if not (st.started or _profiler._is_profiler_enabled):
        st.on = False
        return _OFF
    if st.paused:
        return _OFF
    if not st.on:
        st.on = True
        st.clock = _clock_pair()
    return _Span(name, attrs)


def enabled() -> bool:
    """Whether spans are recorded now."""
    return bool(_state.started or _profiler._is_profiler_enabled) and not _state.paused


def start() -> None:
    """Record spans from now until :func:`stop`, with no profiler."""
    _state.started = _state.on = True
    _state.clock = _clock_pair()


def stop() -> None:
    _state.started = False


def spans() -> list[SpanRecord]:
    """The recorded spans, oldest first."""
    return list(_state.records)


def to_unix_ns(t: int) -> int:
    """``perf_counter_ns`` reading ``t`` on the profiler's clock (Unix-epoch
    nanoseconds), by the pair stored when tracing last turned on."""
    a, unix = _state.clock or _clock_pair()
    return t - a + unix


def reset() -> None:
    """Forget every counter and span (the tests' clean slate)."""
    _state.counters.clear()
    _state.records.clear()
    _state.open.clear()
    _state.next_id = 0
