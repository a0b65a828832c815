"""The port's scheduler under speculative decoding against the reference's
on the CPU: ``tests/test_speculative.py``'s scheduler tests (every family's
speculative = plain identity, composition with chunked admission, the
budget boundary, the slack check, the virtual verify ledger, the busy hook,
repetitive prompts) and ``tests/test_faults.py``'s speculation-throttle
tests.

Engines, streams, calibration and chip as in ``test_torch_scheduler``, and
its criterion (``assert_same``): per-request tokens, flags and every
integer counter of ``ServeReport`` identical to the reference's, the floats
within 1e-9 relative (1e-3 where an adaptive policy refit its τ)."""
import numpy as np
import pytest

from repro_torch.serving import scheduler as tsched

from test_torch_scheduler import (FAMILY_ARCHS, JAX, PORT, engines, one_request, run_both,
                                  streams, tokens, virtual_engines)

SPEC_SC = {"max_batch": 3, "max_len": 48, "spec_slack": 4}


def bursty(pair, n=8, **kw):
    kw = {"fast_rate_hz": 2000.0, "slow_rate_hz": 20.0, "seed": 3, "prompt_lens": (4, 9),
          "new_tokens": (1, 6), **kw}
    return streams("bursty_stream", n, vocab_size=pair[1].cfg.vocab_size, **kw)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_speculative_token_identical_every_family(arch):
    """Speculative output is plain decode's, token for token, every cache
    layout (the ssm and hybrid families' state rolled back to the last
    accepted token), in both packages alike."""
    pair = engines(arch, **SPEC_SC)
    reqs = bursty(pair)
    _, block, _, _ = run_both(pair, reqs, policy="adaptive")
    _, spec, _, sched = run_both(pair, reqs, policy="adaptive", speculate_k=4)
    assert spec.mode == "speculative" and spec.verify_ticks > 0
    assert sched.admitted == sched.completed == len(reqs[1])
    assert sched.pool.active_count == 0
    assert tokens(block) == tokens(spec)
    assert spec.accepted_tokens == sum(len(r.tokens) - 1 for r in spec.records)
    assert spec.accepted_per_tick >= 1.0


def test_speculative_composes_with_chunked_admission():
    pair = engines("granite-3-8b", **SPEC_SC)
    reqs = bursty(pair)
    _, block, _, _ = run_both(pair, reqs, policy="adaptive")
    _, spec, _, sched = run_both(pair, reqs, policy="adaptive", prefill_chunk=4,
                                 speculate_k=4)
    assert spec.mode == "speculative" and spec.chunks > 0 and spec.verify_ticks > 0
    assert not sched.pool.admitting.any() and sched.pool.active_count == 0
    assert tokens(block) == tokens(spec)


@pytest.mark.parametrize("budget", (1, 2, 3))
def test_speculative_budget_boundary_no_overshoot(budget):
    """A slot whose remaining budget is below the accepted window retires
    mid-verify with exactly its budget."""
    pair = engines("whisper-tiny", max_batch=2, max_len=32, spec_slack=6)
    reqs = one_request(4, budget, seed=1)
    _, rep, _, sched = run_both(pair, reqs, policy="idle_waiting", speculate_k=6)
    assert len(rep.records[0].tokens) == budget
    assert rep.records[0].tokens == pair[1].generate(reqs[1][0].prompt[None], budget)[0].tolist()
    assert sched.pool.active_count == 0


def test_speculative_requires_slack():
    pair = engines("granite-3-8b", max_batch=2, max_len=32, spec_slack=2)
    for P, eng in zip((JAX, PORT), pair):
        with pytest.raises(ValueError, match="spec_slack"):
            P.sched.ContinuousBatchingScheduler(
                eng, policy="adaptive", speculate_k=4,
                calibration=P.sched.FixedCalibration(step_s=0.004))
    # the port's engine refuses the window itself, as a ValueError
    with pytest.raises(ValueError, match="spec_slack"):
        pair[1].masked_speculative_step(pair[1].make_pool(), np.zeros((2, 4), np.int32))


VCAL = dict(step_s=0.004, prefill_base_s=0.001, prefill_per_tok_s=5e-4, verify_per_tok_s=2e-4)


def test_virtual_speculative_ledger_deterministic():
    """The virtual model's chain is all zeros: the drafter locks on after
    one tick, verify ticks cost step + K x per-candidate, and the run ends
    sooner than plain decode."""
    pair = virtual_engines(max_batch=4, max_len=64, spec_slack=4)
    assert tsched.FixedCalibration(**VCAL).verify_s(4) == pytest.approx(0.004 + 4 * 2e-4)
    reqs = streams("poisson_stream", 12, rate_hz=50.0, seed=0, vocab_size=64,
                   prompt_lens=(8,), new_tokens=(4, 8))
    _, a, _, _ = run_both(pair, reqs, cal=VCAL, policy="adaptive", execute=False,
                          speculate_k=4)
    _, b, _, _ = run_both(pair, reqs, cal=VCAL, policy="adaptive", execute=False,
                          speculate_k=4)
    assert a.energy_j == b.energy_j and a.p50_s == b.p50_s
    assert a.verify_ticks > 0 and a.accepted_per_tick > 1.0
    _, plain, _, _ = run_both(pair, reqs, cal=VCAL, policy="adaptive", execute=False)
    assert a.time_s < plain.time_s


def test_policy_sees_verify_ticks():
    pair = virtual_engines(max_batch=2, max_len=64, spec_slack=2)
    reqs = streams("poisson_stream", 6, rate_hz=50.0, seed=0, vocab_size=64,
                   prompt_lens=(8,), new_tokens=(2, 6))
    _, rep, js, ts = run_both(pair, reqs, cal=VCAL, policy="adaptive", execute=False,
                              speculate_k=2)
    busy = ts.policy.busy_s
    assert busy["prefill"] > 0 and busy["verify"] > 0 and "decode" not in busy
    assert busy["verify"] == pytest.approx(rep.verify_ticks * ts.cal.verify_s(2))
    assert busy == pytest.approx(js.policy.busy_s, rel=1e-9)


def test_repetitive_prompts_lift_acceptance():
    pair = engines("whisper-tiny", max_batch=4, max_len=32, spec_slack=4)
    reqs = bursty(pair, n=6, seed=1, prompt_lens=(4, 8), new_tokens=(6, 12), prompt_period=4)
    for r in reqs[1]:
        assert (r.prompt[4:] == r.prompt[: len(r.prompt) - 4]).all()
    _, rep, _, _ = run_both(pair, reqs, policy="adaptive", speculate_k=4)
    assert rep.accepted_per_tick > 1.0


# ---------------------------------------------------------------------------
# the speculation throttle (tests/test_faults.py)
# ---------------------------------------------------------------------------
def test_spec_throttle_requires_speculation():
    pair = virtual_engines(max_batch=4, max_len=64)
    with pytest.raises(ValueError, match="spec_throttle"):
        tsched.ContinuousBatchingScheduler(
            pair[1], execute=False, calibration=tsched.FixedCalibration(**VCAL),
            policy="on_off", spec_throttle=True)


def test_throttle_falls_back_to_plain_decode_on_hostile_stream():
    """Random prompts: n-gram drafts rarely match, the throttle closes the
    window and the pool runs plain decode ticks; the output is still the
    greedy chain."""
    pair = engines("granite-3-8b", max_batch=2, max_len=48, spec_slack=4)
    reqs = one_request(6, 24, seed=3)
    _, rep, _, _ = run_both(pair, reqs, policy="idle_waiting", speculate_k=4,
                            spec_throttle=True)
    assert rep.records[0].tokens == pair[1].generate(reqs[1][0].prompt[None], 24)[0].tolist()
    assert rep.throttled_ticks > 0


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_virtual_throttled_runs_match_the_reference(seed):
    """The throttle's windows on the virtual model (whose chain is all
    zeros, so drafts from random prompts miss at first and then lock on):
    the same ticks, windows and ledger in both packages."""
    pair = virtual_engines(max_batch=4, max_len=64, spec_slack=4)
    reqs = streams("poisson_stream", 10, rate_hz=80.0, seed=seed, vocab_size=64,
                   prompt_lens=(4, 8), new_tokens=(4, 16))
    _, rep, _, _ = run_both(pair, reqs, cal=VCAL, policy="idle_waiting", execute=False,
                            speculate_k=4, spec_throttle=True)
    assert rep.verify_ticks > 0 and rep.items == 10
