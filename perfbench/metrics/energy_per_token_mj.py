"""The card's energy over the window (its NVML energy counter, else
power.draw sampled and integrated) over the output tokens of the window."""


def read(run):
    tokens = run.tokens_in_window()
    if run.power is None or run.power.energy_j is None or not tokens:
        return None
    return run.power.energy_j / tokens * 1e3
