"""HBM bytes the window's work needs (the model module's ``work_bytes``: the
weights once a step, each live slot's cache rows up to its position, the
rows a prefill or chunk writes) over the window's seconds x 3.35 TB/s, in
%; the profiler's interval left out of both (``Run.excluded``)."""
from perfbench import counts


def read(run):
    nbytes = sum(run.model.work_bytes(run.sizes, w.kind, **w.args) for w in run.work_in_window())
    return 100.0 * nbytes / (run.clear_s * counts.PEAK_BYTES_PER_S) if nbytes else None
