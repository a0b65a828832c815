"""Median host-clock time of one ``chunked_prefill_step`` and the
synchronisation after it, in the window outside the profiler's interval
(``Run.excluded``).  It reads ``chunk_ms.<cell>`` in every cell that names
one."""
from perfbench.stats import median


def read(run):
    m = median(run.span_seconds("chunk"))
    return None if m is None else m * 1e3
