"""1 - the union of the device's operation intervals over the profiled
sub-window, in %."""


def read(run):
    t = run.trace
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
