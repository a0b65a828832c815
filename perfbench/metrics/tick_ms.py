"""Wall time of all ``masked_decode_step`` calls (the replayed graph, its
inputs loaded and its tokens read back) over their count, in the window
outside the profiler's interval (``Run.excluded``)."""


def read(run):
    ticks = run.span_seconds("tick")
    return sum(ticks) / len(ticks) * 1e3 if ticks else None
