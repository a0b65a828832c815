"""The port's arrival processes (``repro_torch.serving.load``) against the
reference's: the same seed and arguments give the same ``Request`` list in
both packages, field for field, with prompts equal bit for bit and arrival
times equal exactly (both draw from ``np.random.default_rng`` in the same
order).  Tolerance: none; every comparison is exact equality."""
import dataclasses

import numpy as np
import pytest

from repro.serving import load as jload
from repro_torch.serving import load as tload

FIELDS = ("rid", "arrival_s", "new_tokens", "deadline_s", "tier")


def assert_same_requests(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__ == "Request"
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)


# (name, kwargs) covering every option of each stream: prompt buckets and
# periods, budgets, deadlines and SLO tiers
STREAMS = [
    ("poisson_stream", dict(rate_hz=40.0)),
    ("poisson_stream", dict(rate_hz=400.0, prompt_lens=(4, 8), new_tokens=(4, 24),
                            deadline_s=0.5, tier_mix=0.3)),
    ("poisson_stream", dict(rate_hz=5.0, vocab_size=97, prompt_period=3)),
    ("bursty_stream", dict(fast_rate_hz=200.0, slow_rate_hz=2.0)),
    ("bursty_stream", dict(fast_rate_hz=50.0, slow_rate_hz=0.5, p_leave_burst=0.05,
                           p_enter_burst=0.4, prompt_period=4, tier_mix=0.5)),
    ("diurnal_stream", dict(base_rate_hz=10.0, peak_rate_hz=50.0, period_s=3.0)),
    ("diurnal_stream", dict(base_rate_hz=1.0, peak_rate_hz=9.0, period_s=0.5,
                            deadline_s=0.1, tier_mix=0.2)),
    ("flash_crowd_stream", dict(base_rate_hz=10.0, spike_rate_hz=100.0,
                                spike_start_s=1.0, spike_len_s=2.0)),
    ("flash_crowd_stream", dict(base_rate_hz=2.0, spike_rate_hz=200.0, spike_start_s=0.5,
                                spike_len_s=0.5, prompt_period=5, tier_mix=0.7)),
    ("shared_prefix_stream", dict(rate_hz=30.0, prefix_len=16, tail_len=4)),
    ("shared_prefix_stream", dict(rate_hz=3.0, prefix_len=5, tail_len=9, warm_s=0.25,
                                  deadline_s=2.0, tier_mix=0.4, new_tokens=(1, 3))),
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name,kw", STREAMS, ids=[f"{n}-{i}" for i, (n, _) in
                                                  enumerate(STREAMS)])
def test_streams_match_the_reference(name, kw, seed):
    got = getattr(tload, name)(150, seed=seed, **kw)
    want = getattr(jload, name)(150, seed=seed, **kw)
    assert_same_requests(got, want)


def test_request_defaults_match_the_reference():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(tload.Request) == fields(jload.Request)


@pytest.mark.parametrize("n,tier_mix,seed", [(40, 0.0, 0), (40, 0.25, 3), (1, 1.0, 5)])
def test_draw_tiers_match_the_reference(n, tier_mix, seed):
    assert tload._draw_tiers(n, tier_mix, seed) == jload._draw_tiers(n, tier_mix, seed)


@dataclasses.dataclass
class Calibration:
    """A stand-in for the scheduler's calibrations: anything with
    ``prefill_s(batch, s0)`` and ``step_s()`` (an affine prefill)."""

    step: float
    base: float
    per_tok: float

    def prefill_s(self, batch: int, s0: int) -> float:
        return self.base + self.per_tok * batch * s0

    def step_s(self) -> float:
        return self.step


CALS = [Calibration(0.002, 0.001, 1e-4), Calibration(0.031, 0.004, 3e-5)]


@pytest.mark.parametrize("cal", CALS)
def test_mean_service_matches_the_reference(cal):
    for kw in ({}, {"prompt_len": 16, "mean_tokens": 20}):
        assert tload.mean_service_s(cal, **kw) == jload.mean_service_s(cal, **kw)


@pytest.mark.parametrize("cal", CALS)
@pytest.mark.parametrize("kw", [{}, {"prompt_lens": (4, 8, 16), "new_tokens": (2, 6),
                                     "burst_factor": 2.0, "prompt_period": 3,
                                     "tier_mix": 0.5, "deadline_s": 0.2}])
def test_bursty_stream_for_service_matches_the_reference(cal, kw):
    got = tload.bursty_stream_for_service(cal, 200, vocab_size=64, seed=2, **kw)
    want = jload.bursty_stream_for_service(cal, 200, vocab_size=64, seed=2, **kw)
    assert_same_requests(got, want)


def test_period_prompts_repeat_their_pattern():
    """``prompt_period``: each prompt is its own random pattern tiled to the
    prompt length (what the n-gram drafter exploits)."""
    for r in tload.poisson_stream(30, rate_hz=10.0, seed=4, prompt_period=3,
                                  prompt_lens=(8, 16)):
        np.testing.assert_array_equal(r.prompt[3:], r.prompt[:-3])
