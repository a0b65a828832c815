"""95th percentile of every gap between consecutive tokens of a request,
both inside the window (host clock): a pool frozen behind a prefill or a
chunk shows here."""
from perfbench.stats import percentile


def read(run):
    gaps = [(b - a) * 1e3 for r in run.records for a, b in zip(r.times, r.times[1:])
            if run.inside(a) and run.inside(b)]
    return percentile(gaps, 95)
