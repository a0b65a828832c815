"""Arrival-process generators: timestamped request streams for the serving
scheduler.

Four processes, all vectorized:

  poisson_stream      homogeneous Poisson arrivals (i.i.d. exponential gaps)
  bursty_stream       Markov-modulated Poisson: bursts of fast arrivals, then
                      long quiets (geometric run lengths, the same
                      construction as ``core.workload.bursty_trace``)
  diurnal_stream      rate-varying Poisson (sinusoidal "day/night" intensity)
                      via Lewis–Shedler thinning
  flash_crowd_stream  step-function overload: baseline Poisson traffic with
                      one bounded window at a many-× spike rate (a launch, a
                      retweet, a retry storm) — the admission-control /
                      load-shedding stress regime
  shared_prefix_stream  common-system-prompt traffic: one shared prefix +
                      per-request random tails — the paged-KV copy-on-write
                      prefix-sharing regime

Per-request prompt lengths are drawn from a small bucket set — the
reference's jitted prefill retraces per distinct prompt length, so a bounded
set keeps its compile count bounded, and the streams keep the same draws so
that one seed gives the same requests in both packages. Output-token
budgets are uniform over a range.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.workload import mmpp_gaps


@dataclasses.dataclass
class Request:
    """One serving request: arrival timestamp + prompt + decode budget."""

    rid: int
    arrival_s: float
    prompt: np.ndarray          # (s0,) int32 token ids
    new_tokens: int             # total tokens to emit (>= 1)
    deadline_s: float | None = None  # max latency before counting as missed
    tier: str = "batch"         # SLO tier: "latency" (interactive) or "batch"


def _draw_tiers(n: int, tier_mix: float, seed: int) -> list[str]:
    """Per-request SLO tiers: each request is "latency" with probability
    ``tier_mix``. Drawn from a SEPARATE generator so enabling tiers never
    perturbs a stream's historical prompts/budgets/arrivals."""
    if tier_mix <= 0:
        return ["batch"] * n
    rng = np.random.default_rng(seed + 0x7138)
    return ["latency" if d < tier_mix else "batch" for d in rng.random(n)]


def _materialize(arrivals: np.ndarray, *, seed: int, vocab_size: int,
                 prompt_lens: tuple[int, ...], new_tokens: tuple[int, int],
                 deadline_s: float | None,
                 prompt_period: int | None = None,
                 tier_mix: float = 0.0) -> list[Request]:
    rng = np.random.default_rng(seed + 1)
    n = arrivals.size
    lens = rng.choice(np.asarray(prompt_lens), size=n)
    budgets = rng.integers(new_tokens[0], new_tokens[1] + 1, size=n)
    tiers = _draw_tiers(n, tier_mix, seed)

    def prompt(i):
        if prompt_period:
            # REPETITIVE prompts: a per-request base pattern tiled out to the
            # prompt length — the templated/structured serving regime
            # (code, form letters, logs) that self-speculative drafting
            # exploits; still i.i.d. random across requests
            pat = rng.integers(0, vocab_size, prompt_period)
            reps = -(-int(lens[i]) // prompt_period)
            return np.tile(pat, reps)[: lens[i]].astype(np.int32)
        return rng.integers(0, vocab_size, lens[i]).astype(np.int32)

    return [
        Request(
            rid=i,
            arrival_s=float(arrivals[i]),
            prompt=prompt(i),
            new_tokens=int(budgets[i]),
            deadline_s=deadline_s,
            tier=tiers[i],
        )
        for i in range(n)
    ]


def poisson_stream(n: int, *, rate_hz: float, seed: int = 0,
                   vocab_size: int = 256, prompt_lens: tuple[int, ...] = (4, 8, 16),
                   new_tokens: tuple[int, int] = (4, 16),
                   deadline_s: float | None = None,
                   prompt_period: int | None = None,
                   tier_mix: float = 0.0) -> list[Request]:
    """Homogeneous Poisson arrivals at ``rate_hz`` requests/second."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, n))
    return _materialize(arrivals, seed=seed, vocab_size=vocab_size,
                        prompt_lens=prompt_lens, new_tokens=new_tokens,
                        deadline_s=deadline_s, prompt_period=prompt_period,
                        tier_mix=tier_mix)


def bursty_stream(n: int, *, fast_rate_hz: float, slow_rate_hz: float,
                  p_leave_burst: float = 0.1, p_enter_burst: float = 0.7,
                  seed: int = 0, vocab_size: int = 256,
                  prompt_lens: tuple[int, ...] = (4, 8, 16),
                  new_tokens: tuple[int, int] = (4, 16),
                  deadline_s: float | None = None,
                  prompt_period: int | None = None,
                  tier_mix: float = 0.0) -> list[Request]:
    """Markov-modulated arrivals: geometric bursts at ``fast_rate_hz``
    separated by geometric quiets at ``slow_rate_hz`` (starts in a burst)."""
    gaps = mmpp_gaps(np.random.default_rng(seed), n, p_leave_busy=p_leave_burst,
                     p_enter_busy=p_enter_burst, fast_scale=1.0 / fast_rate_hz,
                     slow_scale=1.0 / slow_rate_hz)
    return _materialize(np.cumsum(gaps), seed=seed, vocab_size=vocab_size,
                        prompt_lens=prompt_lens, new_tokens=new_tokens,
                        deadline_s=deadline_s, prompt_period=prompt_period,
                        tier_mix=tier_mix)


def bursty_stream_for_service(cal, n: int, *, vocab_size: int, seed: int = 0,
                              prompt_lens: tuple[int, ...] = (4, 8),
                              new_tokens: tuple[int, int] = (8, 32),
                              burst_factor: float = 3.0,
                              quiet_factor: float = 0.02,
                              deadline_s: float | None = None,
                              prompt_period: int | None = None,
                              tier_mix: float = 0.0) -> list[Request]:
    """Bursty stream with rates scaled from a calibration's measured costs:
    sustained bursts (mean ~20 requests) at ``burst_factor``× the mean
    service rate — genuine queue pressure, the regime continuous batching
    exists for — separated by quiets at ``quiet_factor``×
    (duty-cycle-relevant idle). The ONE regime definition shared by the
    serve benchmark, the launcher's compare mode, and the example."""
    service = mean_service_s(cal, prompt_len=max(prompt_lens),
                             mean_tokens=(new_tokens[0] + new_tokens[1]) // 2)
    return bursty_stream(n, fast_rate_hz=burst_factor / service,
                         slow_rate_hz=quiet_factor / service,
                         p_leave_burst=0.05, seed=seed,
                         vocab_size=vocab_size, prompt_lens=prompt_lens,
                         new_tokens=new_tokens, deadline_s=deadline_s,
                         prompt_period=prompt_period, tier_mix=tier_mix)


def flash_crowd_stream(n: int, *, base_rate_hz: float, spike_rate_hz: float,
                       spike_start_s: float, spike_len_s: float, seed: int = 0,
                       vocab_size: int = 256,
                       prompt_lens: tuple[int, ...] = (4, 8, 16),
                       new_tokens: tuple[int, int] = (4, 16),
                       deadline_s: float | None = None,
                       prompt_period: int | None = None,
                       tier_mix: float = 0.0) -> list[Request]:
    """Flash-crowd overload: Poisson at ``base_rate_hz`` with a single
    rectangular spike window [spike_start_s, spike_start_s + spike_len_s)
    at ``spike_rate_hz``, via Lewis–Shedler thinning against the spike rate.

    During the spike, arrivals outrun the service rate by construction (pick
    spike_rate ≫ capacity): the pool saturates, the ready queue grows, and
    deadline-aware shedding — not throughput — decides how much energy turns
    into ON-TIME completions. The shape is a step function rather than a
    sinusoid because overload onset is what admission control has to
    survive; a diurnal ramp gives the scheduler time to drain."""
    assert spike_rate_hz >= base_rate_hz > 0 and spike_len_s > 0
    rng = np.random.default_rng(seed)
    arrivals: list[float] = []
    t = 0.0
    while len(arrivals) < n:
        cand = t + np.cumsum(rng.exponential(1.0 / spike_rate_hz, 4 * n))
        in_spike = ((cand >= spike_start_s)
                    & (cand < spike_start_s + spike_len_s))
        lam = np.where(in_spike, spike_rate_hz, base_rate_hz)
        keep = cand[rng.uniform(size=cand.size) < lam / spike_rate_hz]
        arrivals.extend(keep.tolist())
        t = cand[-1]
    return _materialize(np.asarray(arrivals[:n]), seed=seed,
                        vocab_size=vocab_size, prompt_lens=prompt_lens,
                        new_tokens=new_tokens, deadline_s=deadline_s,
                        prompt_period=prompt_period, tier_mix=tier_mix)


def shared_prefix_stream(n: int, *, rate_hz: float, prefix_len: int,
                         tail_len: int, warm_s: float = 0.0, seed: int = 0,
                         vocab_size: int = 256,
                         new_tokens: tuple[int, int] = (4, 16),
                         deadline_s: float | None = None,
                         tier_mix: float = 0.0) -> list[Request]:
    """Common-system-prompt traffic: every request's prompt is one shared
    ``prefix_len``-token prefix (drawn once per stream) followed by a
    per-request random ``tail_len``-token tail — the application-specific
    regime paged COW prefix sharing exists for. Request 0 arrives alone at
    t=0 (its admission warms the prefix registry); the rest arrive Poisson
    at ``rate_hz`` starting from ``warm_s``. All prompts share one length,
    so chunked admission forms maximal groups."""
    assert n >= 1 and prefix_len >= 1 and tail_len >= 1
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab_size, prefix_len).astype(np.int32)
    arrivals = np.concatenate(
        [[0.0], warm_s + np.cumsum(rng.exponential(1.0 / rate_hz, n - 1))])
    budgets = rng.integers(new_tokens[0], new_tokens[1] + 1, size=n)
    tiers = _draw_tiers(n, tier_mix, seed)
    return [
        Request(
            rid=i,
            arrival_s=float(arrivals[i]),
            prompt=np.concatenate(
                [prefix, rng.integers(0, vocab_size, tail_len).astype(np.int32)]),
            new_tokens=int(budgets[i]),
            deadline_s=deadline_s,
            tier=tiers[i],
        )
        for i in range(n)
    ]


def mean_service_s(cal, *, prompt_len: int = 8, mean_tokens: int = 12) -> float:
    """Rough mean per-request service time from measured step costs
    (``cal`` is any calibration exposing prefill_s/step_s)."""
    return cal.prefill_s(1, prompt_len) + mean_tokens * cal.step_s()


def diurnal_stream(n: int, *, base_rate_hz: float, peak_rate_hz: float,
                   period_s: float, seed: int = 0, vocab_size: int = 256,
                   prompt_lens: tuple[int, ...] = (4, 8, 16),
                   new_tokens: tuple[int, int] = (4, 16),
                   deadline_s: float | None = None,
                   prompt_period: int | None = None,
                   tier_mix: float = 0.0) -> list[Request]:
    """Rate-varying Poisson, λ(t) = base + (peak-base)·(1+sin(2πt/T))/2,
    sampled by Lewis–Shedler thinning against the peak rate."""
    assert peak_rate_hz >= base_rate_hz > 0
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    while len(arrivals) < n:
        # batched candidate generation at the peak rate, then thin
        cand = t + np.cumsum(rng.exponential(1.0 / peak_rate_hz, 4 * n))
        lam = base_rate_hz + (peak_rate_hz - base_rate_hz) * (
            1.0 + np.sin(2.0 * np.pi * cand / period_s)
        ) / 2.0
        keep = cand[rng.uniform(size=cand.size) < lam / peak_rate_hz]
        arrivals.extend(keep.tolist())
        t = cand[-1]
    arrivals = np.asarray(arrivals[:n])
    return _materialize(arrivals, seed=seed, vocab_size=vocab_size,
                        prompt_lens=prompt_lens, new_tokens=new_tokens,
                        deadline_s=deadline_s, prompt_period=prompt_period,
                        tier_mix=tier_mix)
