"""Operations the window's work needs (the model module's ``work_ops``: 2 x
matmul params x tokens, attention over the live context, the LM head a
token emitted) over the window's seconds x the card's int8 dense peak, in
%; the profiler's interval left out of both (``Run.excluded``)."""
from perfbench import counts


def read(run):
    ops = sum(run.model.work_ops(run.sizes, w.kind, **w.args) for w in run.work_in_window())
    return 100.0 * ops / (run.clear_s * counts.PEAK_INT8_OPS) if ops else None
