"""The share of the cache rows decode attention scores that hold a live
position, in %: the program's ``attn.rows_live`` (each decoding slot's pos
+ 1 rows, once a call) over its ``attn.rows_scored`` (the pool's slots x
its capacity, once a call), summed over the program's ``tick`` spans
inside the window.  The program records spans only while a profiler
records (``repro_torch.core.tracing``), so these are the profiled
sub-window's ticks; a program without the tracer reads nothing."""
import sys


def read(run):
    tracing = sys.modules.get("repro_torch.core.tracing")
    if tracing is None:
        return None
    live = scored = 0
    for s in tracing.spans():
        if s.name == "tick" and run.t0 * 1e9 <= s.t0 and s.t1 <= run.t1 * 1e9:
            live += s.counters.get("attn.rows_live", 0)
            scored += s.counters.get("attn.rows_scored", 0)
    return 100.0 * live / scored if scored else None
