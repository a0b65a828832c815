"""The port's scheduler under seeded faults against the reference's on the
CPU: ``tests/test_faults.py``'s scheduler tests.  Faulted runs give the
fault-free run's tokens in every family (quarantine, then a re-prefill of
the committed context), speculative ones too; chunk faults degrade to
blocking admission; the retry budget fails requests; the same profile gives
the same report; queue-depth backpressure, deadline shedding and the
straggler detector.  And the engine now takes ``ServeConfig.faults``, which
the scheduler reads when it is given no profile of its own.

Engines, streams, calibration and chip as in ``test_torch_scheduler``, and
its criterion (``assert_same``): per-request tokens, flags and every
integer counter of ``ServeReport`` identical to the reference's (the fault
draws come from both packages' ``FaultInjector`` on one seed, in the same
tick order), the floats within 1e-9 relative."""
import pytest

from repro_torch.serving import engine as tengine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import scheduler as tsched

from test_torch_scheduler import (FAMILY_ARCHS, TPU_LIKE, CAL, assert_same, engines, run_both,
                                  streams, tokens, virtual_engines)


def faulted(**kw):
    return lambda P: {"faults": P.faults.FaultProfile(**kw)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_faulted_run_token_identical_every_family(arch):
    pair = engines(arch, max_batch=2, max_len=32)
    reqs = streams("poisson_stream", 6, rate_hz=40.0, seed=1,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(4, 6), new_tokens=(2, 6))
    _, clean, _, _ = run_both(pair, reqs, policy="idle_waiting")
    _, rep, _, sched = run_both(pair, reqs, policy="idle_waiting",
                                make=faulted(seed=7, nan_rate=0.2, stall_rate=0.1,
                                             max_faults=4))
    assert rep.quarantined > 0
    assert rep.failed == 0 and rep.shed == 0
    assert rep.retried <= rep.quarantined
    assert all(r.retries <= sched.retry.max_restarts for r in rep.records)
    assert tokens(rep) == tokens(clean)
    assert rep.energy_j > clean.energy_j and rep.wasted_energy_j > 0


def test_speculative_faulted_run_token_identical():
    pair = engines("granite-3-8b", max_batch=2, max_len=40, spec_slack=4)
    reqs = streams("poisson_stream", 6, rate_hz=40.0, seed=2,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(4, 6), new_tokens=(2, 8),
                   prompt_period=3)
    _, clean, _, _ = run_both(pair, reqs, policy="idle_waiting", speculate_k=4)
    _, rep, _, _ = run_both(pair, reqs, policy="idle_waiting", speculate_k=4,
                            spec_throttle=True, make=faulted(seed=5, nan_rate=0.25, max_faults=3))
    assert rep.quarantined > 0 and rep.failed == 0
    assert tokens(rep) == tokens(clean)


def test_chunk_fault_degrades_to_blocking_token_identical():
    """Every chunk tick fails: the group exhausts its retry budget, falls
    back to blocking admission, and still emits the same tokens."""
    pair = engines("granite-3-8b", max_batch=2, max_len=40)
    reqs = streams("poisson_stream", 5, rate_hz=60.0, seed=3,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(8,), new_tokens=(2, 5))
    _, clean, _, _ = run_both(pair, reqs, policy="idle_waiting", prefill_chunk=4)
    _, deg, _, _ = run_both(pair, reqs, policy="idle_waiting", prefill_chunk=4,
                            make=faulted(seed=1, chunk_fault_rate=1.0))
    assert deg.degraded == 1
    assert deg.chunk_faults == deg.chunks
    assert deg.items == 5 and deg.failed == 0
    assert tokens(deg) == tokens(clean)
    assert deg.wasted_energy_j > 0


# ---------------------------------------------------------------------------
# retry budget, backpressure, shedding, stragglers (engine-free)
# ---------------------------------------------------------------------------
def virtual(reqs, make=None, **kw):
    """``tests/test_faults.py``'s ``_virtual_sched``: the reduced granite
    config, a virtual pool of 4 x 64, fixed costs, on-off."""
    pair = virtual_engines("granite-3-8b", max_batch=4, max_len=64)
    return run_both(pair, reqs, policy="on_off", execute=False, make=make, **kw)


def test_retry_budget_exhaustion_fails_request():
    """nan_rate=1.0 poisons every tick: every request burns its whole retry
    budget and fails, every joule of it wasted."""
    reqs = streams("poisson_stream", 3, rate_hz=50.0, seed=0, new_tokens=(4, 8))
    _, rep, _, _ = virtual(reqs, make=lambda P: {
        "faults": P.faults.FaultProfile(seed=0, nan_rate=1.0),
        "retry": P.retry.RestartPolicy(max_restarts=2, backoff_s=0.001)})
    assert rep.failed == 3 and rep.items == 0
    assert all(r.failed and r.retries == 2 for r in rep.records)
    assert rep.wasted_energy_j == pytest.approx(sum(r.energy_j for r in rep.records))


def test_fault_determinism_same_profile_same_report():
    reqs = streams("poisson_stream", 12, rate_hz=60.0, seed=4, new_tokens=(2, 8))
    make = faulted(seed=9, nan_rate=0.1, stall_rate=0.2)
    _, a, _, _ = virtual(reqs, make=make)
    _, b, _, _ = virtual(reqs, make=make)
    assert_same(a, b, rel=0.0)
    assert a.quarantined > 0


def test_queue_limit_backpressure_sheds_at_ingress():
    flood = streams("flash_crowd_stream", 50, base_rate_hz=5.0, spike_rate_hz=500.0,
                    spike_start_s=0.5, spike_len_s=0.2, seed=2)
    _, rep, _, _ = virtual(flood, queue_limit=4)
    assert rep.shed > 0 and rep.items + rep.shed == 50
    assert all(not r.tokens and r.energy_j == 0 for r in rep.records if r.shed)


def test_deadline_shedding_beats_serve_everything_goodput():
    flood = streams("flash_crowd_stream", 60, base_rate_hz=5.0, spike_rate_hz=400.0,
                    spike_start_s=1.0, spike_len_s=0.5, seed=2, deadline_s=0.3)
    _, noshed, _, _ = virtual(flood, shed=False)
    _, shedr, _, _ = virtual(flood, shed=True)
    assert noshed.missed > 0 and shedr.shed > 0
    assert shedr.missed < 0.2 * noshed.missed
    assert shedr.goodput_per_joule >= noshed.goodput_per_joule


def test_straggler_detector_counts_persistent_stalls():
    reqs = streams("poisson_stream", 16, rate_hz=100.0, seed=1, new_tokens=(16, 32))
    _, rep, _, _ = virtual(reqs, make=lambda P: {
        "faults": P.faults.FaultProfile(seed=3, stall_rate=0.15, stall_factor=25.0),
        "detector": P.retry.StragglerDetector(patience=1, warmup=2, z_threshold=3.0)})
    assert rep.stragglers > 0 and rep.quarantined == 0


@pytest.mark.parametrize("name", ("light", "heavy"))
def test_named_profiles_on_the_virtual_pool(name):
    """The named profiles (``make_profile``) drive the same fault sequence
    and ledger in both packages."""
    reqs = streams("poisson_stream", 16, rate_hz=80.0, seed=6, new_tokens=(4, 16))
    _, rep, _, _ = virtual(reqs, make=lambda P: {"faults": P.faults.make_profile(name, seed=2)},
                           prefill_chunk=4)
    assert rep.quarantined + rep.chunk_faults + rep.stragglers > 0


# ---------------------------------------------------------------------------
# ServeConfig.faults: the engine takes it, the scheduler reads it
# ---------------------------------------------------------------------------
def test_engine_carries_faults_the_scheduler_injects():
    """An engine built with ``ServeConfig.faults`` constructs (it was once
    refused), and a scheduler given no profile of its own injects the
    engine's: the same report as passing the profile to the scheduler."""
    prof = tfaults.FaultProfile(seed=7, nan_rate=0.2, stall_rate=0.1, max_faults=4)
    _, base = engines("granite-3-8b", max_batch=2, max_len=32)
    eng = tengine.InferenceEngine(base.cfg, params=base.params, device="cpu",
                                  sc=tengine.ServeConfig(max_batch=2, max_len=32, faults=prof))
    assert eng.sc.faults is prof
    reqs = streams("poisson_stream", 6, rate_hz=40.0, seed=1, vocab_size=eng.cfg.vocab_size,
                   prompt_lens=(4, 6), new_tokens=(2, 6))[1]
    kw = dict(policy="idle_waiting", chip=TPU_LIKE, calibration=tsched.FixedCalibration(**CAL))
    sched = tsched.ContinuousBatchingScheduler(eng, **kw)
    assert sched.faults is prof and sched.detector is not None
    from_engine = sched.run(reqs)
    given = tsched.ContinuousBatchingScheduler(base, faults=prof, **kw).run(reqs)
    assert from_engine.quarantined > 0
    assert_same(given, from_engine, rel=0.0)
    # an explicit profile wins over the engine's
    off = tsched.ContinuousBatchingScheduler(eng, faults=tfaults.FaultProfile(), **kw)
    assert off.run(reqs).quarantined == 0
