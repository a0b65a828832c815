"""Request streams for the benchmark's cells, from a traffic file's parameters.

One general generator, ``make_requests``, reads every mix: a later mix is a
new data file under ``perfbench/traffic/``, never new code here.

The lengths and the gaps between arrivals are drawn ONCE from the mix's own
``shape_seed``; ``--seed`` only permutes them, inside consecutive blocks of
``shuffle_block`` requests, and draws the token ids.  So every seed serves
the same prompt and output lengths at the same gaps, in another order
within each few seconds of arrivals, and neither a run's work nor which of
it falls inside the window moves with its seed.

Frozen from ``src/repro_torch/serving/load.py`` at commit d0d3ca4:
``Request`` and the Poisson gaps of ``poisson_stream`` (i.i.d. exponential,
``rng.exponential(1 / rate, n)``), so that later changes to the program
cannot move the yardstick.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request: arrival timestamp + prompt + decode budget."""

    rid: int
    arrival_s: float | None     # seconds from the window's start (None: a closed loop's)
    prompt: np.ndarray          # (s0,) int32 token ids
    new_tokens: int             # total tokens to emit (>= 1), the first included


def draw_lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` lengths from a length spec: ``lognormal`` (median, sigma) or
    ``uniform`` (low, high), rounded and clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * rng.standard_normal(n))
    elif spec["dist"] == "uniform":
        x = rng.uniform(spec["low"], spec["high"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def arrival_gaps(rng: np.random.Generator, traffic: dict, n: int) -> np.ndarray:
    """``n`` gaps between arrivals of an open loop: Poisson at ``rate_hz``."""
    return rng.exponential(1.0 / traffic["rate_hz"], n)


def block_permutation(rng: np.random.Generator, n: int, block: int) -> np.ndarray:
    """A permutation of range(n) that moves each index only inside its
    block of ``block`` consecutive indices."""
    return np.concatenate([a + rng.permutation(min(block, n - a)) for a in range(0, n, block)])


def request_count(traffic: dict, seconds: float) -> int:
    """Requests of one run: an open loop's fill the ramp and the window at
    the mix's mean rate; a closed loop draws ``requests``."""
    if traffic["loop"] == "open":
        return max(1, round(traffic["rate_hz"] * (traffic.get("ramp_s", 0.0) + seconds)))
    return int(traffic["requests"])


def make_requests(traffic: dict, *, seed: int, seconds: float, vocab_size: int) -> list[Request]:
    """The run's requests, in the order they are due (open loop) or handed
    to the clients (closed loop)."""
    n = request_count(traffic, seconds)
    shape = np.random.default_rng(int(traffic["shape_seed"]))
    prompts = draw_lengths(shape, traffic["prompt"], n)
    outputs = draw_lengths(shape, traffic["output"], n)
    run = np.random.default_rng(np.random.SeedSequence(int(seed)))
    block = int(traffic.get("shuffle_block", 8))
    order = block_permutation(run, n, block)
    prompts, outputs = prompts[order], outputs[order]
    arrivals: list[float | None] = [None] * n
    if traffic["loop"] == "open":
        gaps = arrival_gaps(shape, traffic, n)
        span = traffic.get("ramp_s", 0.0) + seconds
        gaps = (gaps * (span / gaps.sum()))[block_permutation(run, n, block)]
        # the first due at the ramp's start, the last inside the window
        arrivals = list(-traffic.get("ramp_s", 0.0) + np.cumsum(gaps) - gaps)
    elif traffic["loop"] != "closed":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    return [Request(rid=i, arrival_s=None if arrivals[i] is None else float(arrivals[i]),
                    prompt=run.integers(0, vocab_size, int(prompts[i])).astype(np.int32),
                    new_tokens=int(outputs[i]))
            for i in range(n)]


def primed_budget(traffic: dict, j: int, primed: int, new_tokens: int) -> int:
    """A closed loop's requests admitted in set-up stand at staggered points
    of their answers, so that they do not all end together: the j-th of
    ``primed`` has ``(j + 1) / primed`` of its output left to emit."""
    if traffic.get("prime") != "staggered":
        return new_tokens
    return max(1, math.ceil(new_tokens * (j + 1) / primed))
