"""Median host-clock time of a blocking ``prefill_into_slot`` in the
window outside the profiler's interval (``Run.excluded``; the call ends
synchronised: it returns a host integer).  It reads ``prefill_ms.<cell>``
in every cell that names one."""
from perfbench.stats import median


def read(run):
    m = median(run.span_seconds("prefill"))
    return None if m is None else m * 1e3
