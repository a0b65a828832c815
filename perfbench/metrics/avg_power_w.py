"""Mean of the card's power.draw samples over the window, the profiler's
interval left out (``Run.excluded``)."""


def read(run):
    watts = run.power_samples()
    return sum(watts) / len(watts) if watts else None
