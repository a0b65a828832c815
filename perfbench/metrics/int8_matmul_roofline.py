"""K5's share of its roofline in the profiled sub-window, in %: the sum of
each launch's bound (``counts.k5_call_bound_s``, from the shapes the
configuration gives each call) over the sum of K5's device time.  Nothing
is read unless the launches counted from the configuration, the port's
launch counter and the trace's K5 events all agree."""


def read(run):
    t = run.trace
    if t is None or not t["k5_events"] or not t["k5_device_s"]:
        return None
    if not t["k5_counted"] == t["k5_launches"] == t["k5_events"]:
        return None
    return 100.0 * t["k5_bound_s"] / t["k5_device_s"]
