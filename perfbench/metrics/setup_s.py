"""Seconds from the process's start to the window's: imports, the kernel
library (built on a checkout's first run), weights from the seed, the K5
geometry of the cell's shapes, the graph capture, and the ramp or the
primed clients."""


def read(run):
    return run.setup_s
