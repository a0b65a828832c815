"""The port's scheduler under a brownout governor, seeded faults and page
pressure together, against the reference's, on the CPU:
``tests/test_brownout.py``'s token-identity tests.  Every request completed
under a thermal dip, a cap window, the ladder, the light fault profile,
page pressure and thermal faults on an over-committed paged pool gives the
unconstrained run's tokens, in every family, and under speculative decoding
(windows halved, then off, by the governor).

Engines, streams, calibration and chip as in ``test_torch_scheduler``, and
its criterion (``assert_same``): per-request tokens, flags and every
integer counter of ``ServeReport`` identical to the reference's, the floats
within 1e-9 relative."""
import dataclasses

import pytest

from test_torch_preemption import drained, pair_of
from test_torch_scheduler import FAMILY_ARCHS, run_both, streams, tokens


def constrained(P):
    """The light profile with page pressure and thermal faults, all seeded,
    and an envelope deep enough to walk the ladder (the streams are all
    latency-tier, so that even the shed level drops nothing compared)."""
    faults = dataclasses.replace(P.faults.FAULT_PROFILES["light"], seed=3, press_rate=0.5,
                                 press_pages=2, therm_rate=0.2, therm_frac=0.5, therm_ticks=16)
    env = P.power.PowerEnvelope(events=(P.power.ThermalEvent(0.0, 0.6, 0.1),),
                                caps=(P.power.CapWindow(0.01, 0.25, 100.0),))
    return {"faults": faults, "power": env}


def identity_stream(pair, seed, **kw):
    return streams("poisson_stream", 6, rate_hz=40.0, seed=seed,
                   vocab_size=pair[1].cfg.vocab_size, prompt_lens=(4, 6), new_tokens=(2, 8),
                   tier_mix=1.0, **kw)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_brownout_token_identity_every_family(arch):
    ref, tight = pair_of(arch)
    reqs = identity_stream(ref, 1)
    _, base, _, _ = run_both(ref, reqs, policy="idle_waiting")
    _, rep, _, sched = run_both(tight, reqs, policy="idle_waiting", preempt="tiered",
                                brownout="ladder", make=constrained)
    assert rep.failed == 0 and rep.shed == 0
    assert tokens(rep) == tokens(base)
    assert rep.cap_violation_ticks == 0
    assert rep.brownout_ticks > 0 and rep.time_s > base.time_s
    drained(sched)


def test_speculative_brownout_identity():
    ref, tight = pair_of("granite-3-8b")
    reqs = identity_stream(ref, 2, prompt_period=3)
    _, base, _, _ = run_both(ref, reqs, policy="idle_waiting", speculate_k=3)
    _, rep, _, sched = run_both(tight, reqs, policy="idle_waiting", speculate_k=3,
                                preempt="tiered", brownout="ladder", make=constrained)
    assert rep.failed == 0 and tokens(rep) == tokens(base)
    assert rep.cap_violation_ticks == 0
    drained(sched)
