"""90th percentile of time to first token over every request due in the
window, from its scheduled arrival to its first token on the host; a
request with no first token by the window's end counts at (end - due)."""
from perfbench.stats import percentile


def read(run):
    ttft = []
    for r in run.records:
        if r.req.arrival_s is None or not run.inside(r.due):
            continue
        first = r.times[0] if r.times and r.times[0] <= run.t1 else run.t1
        ttft.append((first - r.due) * 1e3)
    return percentile(ttft, 90)
