"""Every output token the host received inside the window, first tokens
included, over the window's seconds (host clock)."""


def read(run):
    return run.tokens_in_window() / run.window_s
