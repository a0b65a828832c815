"""Continuous-batching serving scheduler with online workload-adaptive duty
cycling.

The subsystem the paper's RQ2 taxonomy needs at serving time: requests
arrive as a timestamped stream, are admitted into free decode slots
MID-DECODE (``serving/slots.py``), and the accelerator's between-work
behaviour is decided live by an online duty-cycle policy
(``serving/policy.py``).

Scheduler states → the paper's strategy taxonomy (§3.2):

  DECODING   slot pool non-empty — one masked decode step per tick (a
             replayed CUDA graph on the card, ``serving/graphs.py``);
             energy = H100Chip.step_power(measured utilization) · t_step,
             amortized equally over the active slots. Partial occupancy is
             the *continuous* analogue of Slow-Down: the linear idle→peak
             power model charges a half-empty pool roughly the static floor
             the paper's clock-stretching pays. With ``speculate_k=K`` the
             tick is SPECULATIVE: an n-gram drafter proposes K candidates
             per slot, one batched verify pass scores every slot's K+1
             window, and each slot commits its greedily-accepted prefix —
             several tokens per tick on repetitive output, with the tick
             charged as one step plus a per-candidate increment and
             amortized over the slots by tokens committed.
  PREFILL    an admission in flight — compute-dense, charged at full
             utilization, billed to the admitted request's ledger. With
             ``prefill_chunk`` set, admission is CHUNKED: a FIFO group of
             same-prompt-length requests advances one chunk per tick while
             the masked decode step keeps serving the decoding slots, so a
             long prompt no longer freezes the pool.
  IDLE       pool drained, next arrival ahead: the policy holds the device
             configured at P_idle (paper: Idle-Waiting), either for the
             whole gap or up to its threshold τ.
  OFF        the policy powered the device down (paper: On-Off past τ =
             adaptive ski-rental); the next admission pays the
             reconfiguration energy E_cfg and wake latency t_cfg — on the
             card, loading the kernel library and refilling the weights
             over PCIe (``engine.gpu_reload_costs``).

The per-request ledger (prefill cost + amortized decode-step cost + wake
latency) rolls up into a ``ServeReport`` whose ``to_sim_result()`` matches
``core.workload.SimResult``, so the offline strategy scorer and the online
scheduler are directly comparable in items/J.

Robustness layer (overload + faults are routine at deployment scale):

  FAULT MODEL  a seeded ``serving/faults.FaultProfile`` injects three fault
             classes in deterministic tick order: NaN cache poisoning
             (caught the same tick by the engine's finiteness guard),
             stall ticks (duration ×stall_factor, fed to the shared
             ``core.retry.StragglerDetector``), and lost chunked-prefill
             steps. Reruns of the same stream + profile replay the identical
             fault sequence.
  RETRY        a poisoned slot is QUARANTINED: the slot retires, nothing
             from the faulted tick is committed, and the request re-enters
             through a bounded-backoff retry queue
             (``core.retry.RestartPolicy``, delays in virtual time). The
             re-admission re-prefills the request's COMMITTED context
             (prompt + all-but-last emitted token) with its last committed
             token as the next decode input, so the greedy continuation is
             token-for-token what a fault-free run emits. Past the retry
             budget the request is FAILED and its whole energy counted
             wasted. Chunk faults retry in place; past the budget the group
             degrades to blocking admission and chunking stays off for the
             rest of the run.
  SHEDDING     with ``shed=True``, admission is deadline-aware: a request is
             served only if the fixed cost model (prefill + one step per
             remaining token) says it can finish inside its deadline —
             infeasible requests are shed at admission (and the ready queue
             is re-scanned every tick, so requests that became hopeless
             while waiting are dropped before they burn prefill energy).
             ``queue_limit`` adds queue-depth backpressure at ingress.
             Serving everything under a flash crowd melts items/J — every
             late request still pays full energy; shedding converts that
             wasted work into on-time completions (see the overload BENCH
             scenario).
  DEGRADATION  ``spec_throttle=True`` lets speculation degrade gracefully:
             a per-request acceptance-EMA throttle halves a stalling
             request's draft window (regrowing on recovery), and a pool
             whose windows all hit 0 falls back to plain decode ticks.
  PREEMPTION   (paged pools) page exhaustion is a scheduling event, never a
             crash. A WATERMARK runs before every decode/verify tick: the
             worst-case page growth of the tick (decode boundary crossings,
             the K+1 speculative window, pending COW) is summed via
             ``PagedSlotPool.blocks_needed`` and compared against
             free + evictable pages net of admitting-group reservations;
             demand past the mark preempts victims picked by a pluggable
             ``PreemptionPolicy`` (SLO tier, deadline slack, page
             footprint, progress). Each victim is restored by whichever
             path the fixed cost model prices cheaper: SWAP (pages copied
             to a host buffer at ``chip.reload_bw``, restored into fresh
             pages bit-identically) or RECOMPUTE (re-prefill of prompt +
             committed tokens through ``resume_into_slot``, exactly the
             quarantine-retry path) — both charged to the energy ledger
             and surfaced as preemption waste. Victims re-enter through
             the retry queue WITHOUT consuming retry budget (preemption is
             the scheduler's fault, not the request's). If a tick still
             hits ``PageExhausted`` (stale evictable estimate, page-
             pressure fault), the scheduler catches it, preempts one more
             victim, and retries the tick.
  SLO TIERS    ``Request.tier`` ("latency" | "batch") drives preemption:
             latency-tier requests are promoted to the head of the ready
             queue, and a latency arrival that cannot admit may preempt a
             batch-tier slot instead of queueing. Preempted batch requests
             re-admit from the retry queue, so batch traffic is delayed,
             never starved.
  POWER        a ``serving/power.PowerEnvelope`` makes the watts a time-
             varying input: thermal events stretch busy ticks by 1/f and
             scale the dynamic power term by f (``H100Chip.dvfs_power``),
             sustained cap windows bound the rolling-window average draw,
             and ``ServeConfig.energy_budget_j`` enforces a hard energy
             budget per window. Enforcement inserts idle before a busy
             tick until its window fits (so ``cap_violation_ticks`` is 0
             by construction under a governor), and a hysteretic
             ``serving/brownout.BrownoutController`` walks a degradation
             ladder — spec window halved, spec off, chunked→blocking,
             Slow-Down pacing, batch-tier preemption, batch-tier shedding
             — so the latency tier is the last thing to feel the squeeze.
             Every ladder action reuses a mechanism already proven token-
             exact, so a brownout changes scheduling only: completed
             requests are token-for-token identical to the unconstrained
             run.

``run_static_batches`` is the baseline this subsystem replaces: fixed-batch
lockstep serving (wait to fill a batch or flush on timeout, pad every
request to the cohort's longest prompt and largest token budget).

On the card (the PyTorch/CUDA port of the JAX package's scheduler, with the
same names, control flow and ledger): the scheduler is host logic (numpy,
plain floats) around the engine's calls, and runs the engine on whatever
device the engine was built for, never moving work elsewhere; an adaptive
policy refits τ on that device too.  On a paged pool a mid-tick
``PageExhausted`` leaves ``ensure_writable`` on the host before anything is
replayed: the blocks it already repointed keep their enqueued copies, so
the table is consistent when the scheduler preempts a victim and retries
the tick, and the captured tick never reads a half-updated table.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.energy import DEFAULT_CHIP, H100Chip
from repro_torch.core.retry import RestartPolicy, StragglerDetector
from repro_torch.core.workload import AccelProfile, SimResult
from repro_torch.serving.brownout import BrownoutController, make_governor
from repro_torch.serving.draft import NgramDrafter, SpecThrottle
from repro_torch.serving.engine import ChunkedPrefillState, InferenceEngine, gpu_reload_costs
from repro_torch.serving.faults import FaultInjector, FaultProfile
from repro_torch.serving.load import Request
from repro_torch.serving.pages import PageExhausted, PagedSlotPool
from repro_torch.serving.policy import DutyCyclePolicy, make_policy
from repro_torch.serving.power import PowerEnvelope, RollingLedger
from repro_torch.serving.slots import SlotPool


# ---------------------------------------------------------------------------
# Measured per-step costs (the virtual-time ledger's inputs)
# ---------------------------------------------------------------------------
class EngineCalibration:
    """Measured wall-times of the engine's steps.

    Timing is measured once per signature and reused: the first call warms
    up (first launches, the tuner's picks, and for the decode and verify
    ticks the capture of their CUDA graphs) and is not timed.  The virtual
    clock advances by CALIBRATED cost per operation, so scheduler runs are
    deterministic given a calibration while every token still comes from
    real execution.  On the card every timed call ends with
    ``torch.cuda.synchronize``, so a time covers the device work it
    enqueued.  Prefill and chunk steps run eagerly (their lengths vary), so
    their costs hold the host time of every launch; the decode and verify
    ticks are replayed graphs.

    ``step_s`` and ``verify_s`` tick a full pool of their own (every slot
    active at position 0), never the scheduler's, and drop it, with its
    graphs, once timed.
    """

    def __init__(self, engine: InferenceEngine, *, repeats: int = 3):
        self.engine = engine
        self.repeats = repeats
        self._prefill: dict[tuple[int, int], float] = {}
        self._chunkt: dict[tuple[int, int], float] = {}
        self._verify: dict[int, float] = {}
        self._step: float | None = None

    def _time(self, fn) -> float:
        dev = self.engine.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        fn()  # warm-up: first launches, graph capture
        sync()
        best = math.inf
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def _full_pool_tick(self, tick) -> float:
        """Time ``tick(pool)`` on a throwaway full pool; the pool and the
        graphs the engine captured on it are dropped afterwards."""
        eng = self.engine
        pool = eng.make_pool()
        pool.active[:] = True  # full occupancy; positions stay at 0
        try:
            return self._time(lambda: tick(pool))
        finally:
            eng._graphs.pop(pool, None)

    def prefill_s(self, batch: int, s0: int) -> float:
        key = (batch, s0)
        if key not in self._prefill:
            eng = self.engine
            prompts = torch.zeros((batch, s0), dtype=torch.int64, device=eng.device)
            self._prefill[key] = self._time(
                lambda: eng._prefill(eng.params, prompts, eng._frontend_stub(batch))
            )
        return self._prefill[key]

    def chunk_s(self, batch: int, chunk_tokens: int) -> float:
        """One chunked-prefill tick (``chunk_tokens`` tokens, group of
        ``batch``) — timed on the REAL chunk step, whose attention spans the
        whole cache capacity, not on a standalone short prefill."""
        key = (batch, chunk_tokens)
        if key not in self._chunkt:
            self._chunkt[key] = self._time(
                self.engine.chunk_step_probe(batch, chunk_tokens))
        return self._chunkt[key]

    def step_s(self) -> float:
        if self._step is None:
            self._step = self._full_pool_tick(self.engine.masked_decode_step)
        return self._step

    def verify_s(self, k: int) -> float:
        """One speculative verify tick (K drafts, full pool) — timed on the
        real K+1-window tick, not extrapolated from the single-token step."""
        if k not in self._verify:
            eng = self.engine
            drafts = np.zeros((eng.sc.max_batch, k), np.int32)
            self._verify[k] = self._full_pool_tick(
                lambda pool: eng.masked_speculative_step(pool, drafts))
        return self._verify[k]


class FixedCalibration:
    """Preset costs — deterministic scheduler runs without any engine."""

    def __init__(self, *, step_s: float, prefill_base_s: float = 0.0,
                 prefill_per_tok_s: float = 0.0,
                 verify_per_tok_s: float = 0.0):
        self._step = step_s
        self.base = prefill_base_s
        self.per_tok = prefill_per_tok_s
        self.verify_per_tok = verify_per_tok_s

    def prefill_s(self, batch: int, s0: int) -> float:
        return self.base + self.per_tok * batch * s0

    # one affine model prices blocking prefills and chunk ticks alike
    chunk_s = prefill_s

    def step_s(self) -> float:
        return self._step

    def verify_s(self, k: int) -> float:
        """Verify tick = one decode step + a per-candidate increment: the
        masked step is weight-bound, so K extra in-flight positions ride the
        same weight reads and only add activation/attention work."""
        return self._step + k * self.verify_per_tok


# ---------------------------------------------------------------------------
# Preemption victim selection
# ---------------------------------------------------------------------------
class PreemptionPolicy:
    """Ranks decoding slots as preemption victims (best victim first).

    Candidates are dicts the scheduler builds per decoding slot:
    ``{"slot", "tier", "slack", "pages", "progress"}`` where ``slack`` is
    seconds until the request's deadline (inf when deadline-free),
    ``pages`` its owned page count, ``progress`` emitted/budget. Orders:

      tiered     batch tier before latency, then most slack, then largest
                 footprint, then least progress (the default — protects
                 interactive traffic, frees the most pages per preempt)
      footprint  largest footprint first, tier-blind (pure memory relief)
      slack      most deadline slack first, tier-blind (deadline-safest)

    All orders break ties on slot index, so victim choice is deterministic.
    """

    ORDERS = ("tiered", "footprint", "slack")

    def __init__(self, order: str = "tiered"):
        if order not in self.ORDERS:
            raise ValueError(
                f"unknown preemption order {order!r}: want one of {self.ORDERS}")
        self.order = order

    def _key(self, c: dict):
        if self.order == "tiered":
            return (0 if c["tier"] == "batch" else 1, -c["slack"],
                    -c["pages"], c["progress"], c["slot"])
        if self.order == "footprint":
            return (-c["pages"], -c["slack"], c["progress"], c["slot"])
        return (-c["slack"], -c["pages"], c["progress"], c["slot"])

    def rank(self, candidates: list[dict]) -> list[dict]:
        return sorted(candidates, key=self._key)


def make_preemption_policy(spec: str | PreemptionPolicy | None):
    if spec is None or isinstance(spec, PreemptionPolicy):
        return spec
    return PreemptionPolicy(spec)


# ---------------------------------------------------------------------------
# Per-request ledger + report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival_s: float
    prompt_len: int
    new_tokens: int
    admit_s: float = math.nan
    finish_s: float = math.nan
    tokens: list[int] = dataclasses.field(default_factory=list)
    energy_j: float = 0.0
    missed: bool = False
    shed: bool = False    # dropped by admission control (never completed)
    failed: bool = False  # quarantined past the retry budget
    retries: int = 0      # quarantine-and-retry re-admissions performed
    waste_j: float = 0.0  # fault-discarded tick shares (subset of energy_j)

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclasses.dataclass
class ServeReport:
    mode: str
    records: list[RequestRecord]
    energy_j: float  # total: initial config + requests + duty-cycle overhead
    time_s: float    # makespan (first arrival → last finish)
    reloads: int
    missed: int
    chunks: int = 0  # prefill chunks processed (chunked admission only)
    verify_ticks: int = 0      # speculative verify passes (speculative only)
    accepted_tokens: int = 0   # tokens committed by those passes
    shed: int = 0              # dropped by admission control / backpressure
    retried: int = 0           # quarantine-and-retry re-admissions
    quarantined: int = 0       # quarantine events (poisoned slots caught)
    failed: int = 0            # requests abandoned past the retry budget
    chunk_faults: int = 0      # lost chunked-prefill ticks
    stragglers: int = 0        # StragglerDetector mitigation signals
    degraded: int = 0          # chunked→blocking admission fallbacks
    throttled_ticks: int = 0   # speculative ticks demoted to plain decode
    wasted_energy_j: float = 0.0  # energy that produced no on-time tokens
    peak_active: int = 0       # max concurrently occupied slots (capacity)
    shared_hit_pages: int = 0  # prefix-registry pages mapped read-only (paged)
    cow_copies: int = 0        # copy-on-write page copies performed (paged)
    evictions: int = 0         # prefix-registry pages LRU-evicted (paged)
    preempted: int = 0         # slots preempted under memory/tier pressure
    swapped: int = 0           # preemptions restored via swap-out/swap-in
    recomputed: int = 0        # preemptions restored via re-prefill
    preempt_wasted_j: float = 0.0  # swap transfers + restore re-prefills
    brownout_ticks: int = 0        # governor updates at a degraded level
    brownout_transitions: int = 0  # ladder level changes (always ±1)
    cap_violation_ticks: int = 0   # busy ticks whose window broke the cap
    brownout_forgone_j: float = 0.0  # idle energy inserted to honour the cap
    level_dwell: tuple = ()        # governor updates observed per level
    peak_window_w: float = 0.0     # peak cap-window mean power (conservative)
    peak_budget_window_j: float = 0.0  # peak energy in any budget window

    @property
    def items(self) -> int:
        """Completed requests — shed and failed requests don't count."""
        return sum(1 for r in self.records if not r.shed and not r.failed)

    @property
    def useful_items(self) -> int:
        """Completed ON TIME: the numerator overload scenarios care about."""
        return sum(1 for r in self.records
                   if not r.shed and not r.failed and not r.missed)

    @property
    def accepted_per_tick(self) -> float:
        """Mean tokens committed per speculative verify tick (>= 1 by
        construction; > 1 is the speedup speculation exists for)."""
        return self.accepted_tokens / self.verify_ticks if self.verify_ticks else 0.0

    @property
    def items_per_joule(self) -> float:
        return self.items / self.energy_j if self.energy_j else 0.0

    @property
    def goodput_per_joule(self) -> float:
        """On-time completions per joule — the shed-vs-serve-everything
        comparison metric (a late completion burned its energy for
        nothing)."""
        return self.useful_items / self.energy_j if self.energy_j else 0.0

    def latency_pct(self, q: float) -> float:
        lats = [r.latency_s for r in self.records if not r.shed and not r.failed]
        if not lats:
            return math.nan
        return float(np.percentile(lats, q))

    @property
    def p50_s(self) -> float:
        return self.latency_pct(50)

    @property
    def p99_s(self) -> float:
        return self.latency_pct(99)

    def to_sim_result(self) -> SimResult:
        return SimResult(self.items, self.energy_j, self.time_s, self.missed)

    def summary(self) -> str:
        extra = f" chunks={self.chunks}" if self.chunks else ""
        if self.verify_ticks:
            extra += (f" verify={self.verify_ticks} "
                      f"acc/tick={self.accepted_per_tick:.2f}")
        if self.shed or self.quarantined or self.failed:
            extra += (f" shed={self.shed} quar={self.quarantined} "
                      f"retry={self.retried} failed={self.failed} "
                      f"goodput/J={self.goodput_per_joule:.5f} "
                      f"wasted={self.wasted_energy_j:.3f}J")
        if self.stragglers or self.degraded or self.throttled_ticks:
            extra += (f" straggle={self.stragglers} degraded={self.degraded} "
                      f"throttled={self.throttled_ticks}")
        if self.preempted:
            extra += (f" preempt={self.preempted} swap={self.swapped} "
                      f"recomp={self.recomputed} "
                      f"preempt_waste={self.preempt_wasted_j:.3f}J")
        if self.evictions:
            extra += f" evict={self.evictions}"
        if self.brownout_ticks or self.cap_violation_ticks:
            extra += (f" brownout={self.brownout_ticks} "
                      f"capviol={self.cap_violation_ticks} "
                      f"forgone={self.brownout_forgone_j:.3f}J")
        return (f"{self.mode:11s} items={self.items} items/J={self.items_per_joule:.5f} "
                f"p50={self.p50_s * 1e3:.1f}ms p99={self.p99_s * 1e3:.1f}ms "
                f"reloads={self.reloads} missed={self.missed}{extra}")


def _gpu_profile(t_step: float, chip: H100Chip, chips: int, cfg) -> AccelProfile:
    """The duty-cycle profile of a served engine: its measured decode step,
    the chip's peak and idle power, and ``gpu_reload_costs`` as the
    configuration energy and time (the reference's ``_tpu_profile``, the
    same arithmetic)."""
    t_reload, e_reload = gpu_reload_costs(cfg, chip, chips=chips)
    return AccelProfile(
        t_inf_s=t_step,
        p_active_w=chip.p_peak_w * chips,
        p_idle_w=chip.p_idle_w * chips,
        e_cfg_j=e_reload,
        t_cfg_s=t_reload,
    )


# ---------------------------------------------------------------------------
# Continuous-batching scheduler
# ---------------------------------------------------------------------------
class ContinuousBatchingScheduler:
    """Request-level scheduler over one ``InferenceEngine`` slot pool.

    ``execute=True`` really runs the engine's prefill / masked decode steps
    (tokens are genuine greedy continuations); ``execute=False`` runs the
    identical admission/retirement/energy logic on a virtual pool with a
    ``FixedCalibration`` — deterministic, engine-free (policy studies).

    ``prefill_chunk=None`` (default) admits with BLOCKING prefill: the whole
    prompt is prefilled in one call and every decoding slot stalls for its
    duration. ``prefill_chunk=C`` switches to CHUNKED admission: a FIFO
    group of waiting same-prompt-length requests reserves free slots and its
    prompts advance C tokens per tick through one batched
    ``chunked_prefill_step`` while the masked decode step keeps serving the
    decoding slots between chunks — a long prompt no longer freezes the
    pool. Both paths emit token-for-token identical outputs: the decode step
    is per-slot independent, so tokens depend only on each request's own
    prefilled cache.

    ``speculate_k=K`` turns decode ticks SPECULATIVE: a per-slot drafter
    (default ``NgramDrafter`` — suffix lookup over each request's own
    prompt + emitted tokens, no extra weights) proposes K candidates per
    decoding slot and ONE batched ``masked_speculative_step`` scores every
    slot's K+1 window, committing each slot's greedily-accepted prefix with
    a variable ``SlotPool.advance``. Acceptance is exact greedy match, so
    speculative output is token-for-token identical to plain masked decode
    — wrong drafts cost only the per-candidate verify increment, and the
    accept-0 floor still commits one token per tick. Composes with chunked
    admission (slots whose prefill is in flight stay out of the verify
    mask). Verify energy is charged per tick at measured occupancy and
    amortized over the slots by tokens committed.

    Robustness (see the module docstring for the full model):

      ``faults``       a seeded ``FaultProfile`` (defaults to the engine's
                       ``ServeConfig.faults``) injects NaN poisoning, stall
                       ticks and chunk faults in deterministic tick order.
                       Poisoned slots are caught by the engine's
                       finiteness guard, quarantined, and re-admitted from
                       their committed tokens under ``retry`` (bounded
                       exponential backoff in virtual time; default budget
                       4 retries with ~2-step base delay). Requests past
                       the budget are failed and their energy counted
                       wasted.
      ``shed``         deadline-aware admission control: requests the fixed
                       cost model says cannot finish inside their deadline
                       are dropped at admission, and the ready queue is
                       re-scanned every tick. ``queue_limit`` bounds the
                       ready queue (ingress backpressure, applies with or
                       without ``shed``).
      ``spec_throttle`` per-request speculation auto-throttle
                       (``draft.SpecThrottle``): acceptance-stalling
                       requests shrink their draft window to 0 and the tick
                       falls back to plain decode; windows regrow on
                       recovery.
      ``preempt``      (paged pools) a ``PreemptionPolicy`` (or its order
                       name) enabling the memory-pressure watermark, SLO-
                       tier preemption of batch slots by latency arrivals,
                       and swap/recompute restore; ``swap=False`` forces
                       every restore down the recompute path. Even with
                       ``preempt=None``, paged runs never crash on page
                       exhaustion: a mid-tick ``PageExhausted`` triggers an
                       emergency preempt-and-retry with a default policy.
      ``power``      a ``PowerEnvelope`` (thermal clock events + sustained
                       cap windows). Busy ticks stretch by 1/f and their
                       dynamic power scales by f; the rolling compliance
                       ledger counts ``cap_violation_ticks`` and — under a
                       governor — inserts idle until every window fits.
                       Auto-created when the fault profile enables the
                       ``therm=`` axis.
      ``brownout``     ``"ladder"`` (hysteretic degradation ladder),
                       ``"uniform"`` (naive pace-everything baseline), a
                       ``BrownoutController`` instance, or None. Also the
                       enforcement arm for ``ServeConfig.energy_budget_j``.
    """

    def __init__(self, engine: InferenceEngine, *,
                 policy: str | DutyCyclePolicy = "adaptive",
                 chip: H100Chip = DEFAULT_CHIP, chips: int = 1,
                 execute: bool = True, calibration=None,
                 prefill_util: float = 1.0, prefill_chunk: int | None = None,
                 speculate_k: int | None = None, drafter=None,
                 policy_kw: dict | None = None,
                 shed: bool = False, queue_limit: int | None = None,
                 faults: FaultProfile | None = None,
                 retry: RestartPolicy | None = None,
                 spec_throttle: bool = False,
                 detector: StragglerDetector | None = None,
                 preempt: str | PreemptionPolicy | None = None,
                 swap: bool = True,
                 power: PowerEnvelope | None = None,
                 brownout: str | BrownoutController | None = None):
        if not execute and calibration is None:
            raise ValueError("execute=False needs an explicit calibration")
        if preempt is not None and not (execute and engine.sc.paged):
            raise ValueError(
                "preempt requires a real paged pool (execute=True and "
                "ServeConfig.paged=True): preemption swaps/recomputes pages")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if speculate_k is not None and speculate_k < 1:
            raise ValueError(f"speculate_k must be >= 1, got {speculate_k}")
        if (speculate_k and execute and not engine.sc.paged
                and engine.sc.spec_slack < speculate_k):
            # paged pools need no spare rows: verify-window tail blocks are
            # allocated on demand (the engine checks the table bound instead)
            raise ValueError(
                f"speculate_k={speculate_k} needs an engine with "
                f"ServeConfig.spec_slack >= {speculate_k} spare cache rows "
                f"(have {engine.sc.spec_slack})")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if spec_throttle and not speculate_k:
            raise ValueError("spec_throttle requires speculate_k")
        self.engine = engine
        self.chip = chip
        self.chips = chips
        self.execute = execute
        self.prefill_util = prefill_util
        self.prefill_chunk = prefill_chunk
        self.speculate_k = speculate_k
        self.drafter = (drafter if drafter is not None
                        else NgramDrafter(speculate_k) if speculate_k else None)
        self.cal = calibration if calibration is not None else EngineCalibration(engine)
        sc = engine.sc
        self.pool = (engine.make_pool() if execute else
                     SlotPool(engine.cfg, max_batch=sc.max_batch,
                              max_len=sc.max_len, virtual=True,
                              slack=sc.spec_slack, device=engine.device))
        self.profile = _gpu_profile(self.cal.step_s(), chip, chips, engine.cfg)
        self.policy = (policy if isinstance(policy, DutyCyclePolicy)
                       else make_policy(policy, self.profile, device=engine.device,
                                   **(policy_kw or {})))
        self.shed = shed
        self.queue_limit = queue_limit
        self.preempter = make_preemption_policy(preempt)
        self.swap = swap
        self.faults = faults if faults is not None else sc.faults
        self.power = power
        self.brownout = brownout
        make_governor(brownout)  # validate the spec eagerly
        if sc.energy_budget_j is not None:
            if sc.budget_window_s <= 0:
                raise ValueError("budget_window_s must be positive")
            floor = chip.p_idle_w * chips * sc.budget_window_s
            if sc.energy_budget_j <= floor:
                raise ValueError(
                    f"energy_budget_j={sc.energy_budget_j} is not above the "
                    f"idle floor {floor:.1f} J per {sc.budget_window_s} s "
                    f"window (p_idle_w x chips): no schedule is feasible")
        # backoff lives in VIRTUAL time, so the default scales with the
        # measured step: first retry waits ~2 ticks, growing 2x per attempt
        step = self.cal.step_s()
        self.retry = retry if retry is not None else RestartPolicy(
            max_restarts=4, backoff_s=2 * step, backoff_factor=2.0,
            max_backoff_s=64 * step)
        self.throttle = (SpecThrottle(speculate_k)
                         if spec_throttle and speculate_k else None)
        self.detector = detector if detector is not None else (
            StragglerDetector()
            if self.faults is not None and self.faults.enabled else None)
        self.admitted = 0
        self.completed = 0
        self.chunks = 0
        self.verify_ticks = 0
        self.accepted_tokens = 0

    # -- one request's terminal bookkeeping ---------------------------------
    def _maybe_finish(self, slot: int, rec: RequestRecord, t: float,
                      deadline_s: float | None) -> None:
        info = self.pool.slots[slot]
        if info.emitted >= info.budget:
            rec.finish_s = t
            rec.missed = deadline_s is not None and rec.latency_s > deadline_s
            self.pool.retire(slot)
            self.completed += 1
            if self.drafter is not None:
                self.drafter.forget(rec.rid)
            if self.throttle is not None:
                self.throttle.forget(rec.rid)

    def _infeasible(self, t: float, context_len: int, remaining: int,
                    arrival_s: float, deadline_s: float | None) -> bool:
        """Deadline feasibility against the fixed cost model: a prefill now
        plus one decode step per still-owed token must land inside the
        deadline. ``remaining`` counts the steps owed AFTER the prefill's
        own emission — ``new_tokens - 1`` for a fresh admission,
        ``budget - emitted`` for a retry (whose re-prefill emits nothing
        new). Speculation can only finish EARLIER than this estimate, so a
        feasible verdict never turns a servable request away."""
        if not self.shed or deadline_s is None:
            return False
        est = (t + self.cal.prefill_s(1, context_len)
               + remaining * self.cal.step_s())
        return est > arrival_s + deadline_s

    def _prefix_len(self, r: Request) -> int:
        """Registered shared-prefix length of a request (tokens) — the extra
        chunked-admission grouping key under paged prefix sharing, so every
        group member skips the SAME resident prefix. 0 whenever sharing is
        off (contiguous pools, virtual pools, share_prefix=False)."""
        if not self.execute or not getattr(self.pool, "share_prefix", False):
            return 0
        return self.pool.match_prefix_len(r.prompt)

    def run(self, requests: Sequence[Request]) -> ServeReport:
        mode = ("speculative" if self.speculate_k
                else "chunked" if self.prefill_chunk else "continuous")
        reqs = sorted(requests, key=lambda r: r.arrival_s)
        if not reqs:
            return ServeReport(mode, [], 0.0, 0.0, 0, 0)
        for r in reqs:
            if r.new_tokens < 1:
                raise ValueError(f"request {r.rid}: new_tokens must be >= 1")
            if len(r.prompt) + r.new_tokens > self.pool.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} + budget "
                    f"{r.new_tokens} exceeds max_len {self.pool.max_len}")
            if isinstance(self.pool, PagedSlotPool):
                # an EMPTY paged pool must always be able to admit: with the
                # worst case bounded by the pool size, blocked admissions
                # only ever wait for pages, never deadlock on them
                need = -(-(len(r.prompt) + r.new_tokens - 1) // self.pool.page)
                if need > self.pool.num_pages - 1:
                    raise ValueError(
                        f"request {r.rid}: worst case {need} pages exceeds "
                        f"the pool's {self.pool.num_pages - 1} allocatable "
                        f"pages (num_pages - scratch)")
        recs = {r.rid: RequestRecord(r.rid, r.arrival_s, len(r.prompt), r.new_tokens)
                for r in reqs}
        deadlines = {r.rid: r.deadline_s for r in reqs}
        by_rid = {r.rid: r for r in reqs}
        tiers = {r.rid: getattr(r, "tier", "batch") for r in reqs}
        self.admitted = self.completed = self.chunks = 0
        self.verify_ticks = self.accepted_tokens = 0
        self.policy.busy_s.clear()  # per-run ledger (τ estimator state persists)
        inj = (FaultInjector(self.faults)
               if self.faults is not None and self.faults.enabled else None)
        n = len(reqs)
        pool, chip, chips = self.pool, self.chip, self.chips
        # POWER: the envelope (scripted, or auto-created so the therm fault
        # axis has somewhere to land its events), a fresh governor for this
        # run, and the rolling compliance ledgers. Without an envelope,
        # governor, or budget all of this is inert and the ledger matches
        # the pre-power behaviour bit for bit (clock_frac == 1 path).
        env = self.power
        if env is None and self.faults is not None and self.faults.therm_rate > 0:
            env = PowerEnvelope()
        if env is not None:
            env.reset()  # drop fault-driven events from any prior run
        gov = make_governor(self.brownout)
        self.last_governor = gov

        def gov_defers(rid: int) -> bool:
            """Hold batch-tier (re-)admission in the governor's preempt
            band, so preemption shrinks the pool instead of churning
            swaps. An EMPTY pool always admits — idle is already the
            power floor, so deferring there would deadlock, not save."""
            return (gov is not None and gov.defer_batch()
                    and tiers[rid] != "latency" and pool.active_count > 0)

        idle_w = chip.p_idle_w * chips
        budget_j = self.engine.sc.energy_budget_j
        cap_ledger = (RollingLedger(env.window_s, floor_w=idle_w)
                      if env is not None else None)
        bud_ledger = (RollingLedger(
            self.engine.sc.budget_window_s,
            cap_w=budget_j / self.engine.sc.budget_window_s,
            floor_w=idle_w) if budget_j is not None else None)
        forgone_j = 0.0        # idle inserted to honour caps/budget
        cap_violations = 0
        t = reqs[0].arrival_s
        gap_energy = 0.0
        reloads = 0
        i = 0                      # next not-yet-ingested arrival
        ready: collections.deque[Request] = collections.deque()
        retry_q: list[dict] = []   # quarantined requests awaiting re-admission
        attempts: dict[int, int] = {}
        group: ChunkedPrefillState | None = None
        group_fails = 0        # consecutive lost chunk ticks of this group
        group_spent_ok = 0.0   # healthy-tick energy sunk into this group
        chunk_disabled = False
        shed = retried = quarantined = failed = 0
        chunk_faults = stragglers = degraded = throttled = 0
        preempted = swapped = recomputed = 0
        preempt_waste = 0.0
        press_pins: list[int] = []
        force_plain = False  # one-shot spec→plain fallback after exhaustion
        paged = isinstance(pool, PagedSlotPool)
        peak_active = 0
        guard = 0
        cn = self.prefill_chunk or 1
        guard_max = 16 * (n + sum(r.new_tokens for r in reqs)
                          + sum(-(-len(r.prompt) // cn) for r in reqs)) + 64
        if inj is not None:
            # every retry re-prefills and re-runs up to a request's whole
            # decode; scale the progress guard by the retry budget
            guard_max *= 2 + self.retry.max_restarts
        if paged and (self.preempter is not None or (
                self.faults is not None and self.faults.press_rate > 0)):
            # preempt/restore cycles add bounded extra iterations per event
            guard_max *= 4
        if gov is not None:
            # governor preemptions and paced/enforced idle add bounded
            # extra iterations per escalation
            guard_max *= 4

        def ingest() -> None:
            """Move everything that has arrived by ``t`` into the ready
            queue, shedding past the ``queue_limit`` backpressure bound —
            or, at the brownout ladder's top level, shedding new batch-tier
            arrivals outright (latency-tier and retry traffic never shed
            here)."""
            nonlocal i, shed
            while i < n and reqs[i].arrival_s <= t:
                r = reqs[i]
                i += 1
                if (self.queue_limit is not None
                        and len(ready) >= self.queue_limit):
                    recs[r.rid].shed = True
                    shed += 1
                elif (gov is not None and gov.shed_batch()
                      and tiers[r.rid] != "latency"):
                    recs[r.rid].shed = True
                    shed += 1
                else:
                    ready.append(r)

        def record_span(t0: float, t1: float, joules: float) -> None:
            """Feed a non-enforced span (swap transfer, stall tail, policy
            gap) to the compliance ledgers and the governor's estimate."""
            if t1 <= t0:
                return
            w = joules / (t1 - t0)
            if cap_ledger is not None:
                cap_ledger.add(t0, t1, w)
            if bud_ledger is not None:
                bud_ledger.add(t0, t1, w)
            if gov is not None:
                gov.observe(t0, t1, joules)

        def busy_tick(kind: str, base_s: float, util: float,
                      stall: float = 1.0) -> tuple[float, float]:
            """One busy tick through the power envelope. The clock fraction
            stretches the calibrated time by 1/f and scales the dynamic
            power term by f (``H100Chip.dvfs_power``); governor pacing plus
            whatever idle the cap/budget ledgers demand is inserted BEFORE
            the tick (so enforced runs break no window, by construction);
            the stall tail is charged at idle power — the device is
            waiting, not computing. Returns (duration, energy) of the tick
            itself; inserted idle is charged to the run's forgone-energy
            ledger, not to any request."""
            nonlocal t, forgone_j, cap_violations
            f = env.clock_frac(t) if env is not None else 1.0
            dur = base_s / f
            busy_w = (chip.dvfs_power(util, f) if env is not None
                      else chip.step_power(util)) * chips
            env_cap = env.cap_w(t) if env is not None else math.inf
            cap_eff = env_cap
            if bud_ledger is not None:
                cap_eff = min(cap_eff, bud_ledger.cap_w)
            idle_s = 0.0
            if gov is not None:
                idle_s = gov.pace_idle(dur, busy_w, cap_eff)
                if cap_ledger is not None:
                    idle_s = max(idle_s, cap_ledger.idle_needed(
                        t, dur, busy_w, cap_w=env_cap))
            if bud_ledger is not None:
                idle_s = max(idle_s, bud_ledger.idle_needed(t, dur, busy_w))
            if idle_s > 0:
                record_span(t, t + idle_s, idle_w * idle_s)
                forgone_j += idle_w * idle_s
                self.policy.on_throttle(idle_s)
                t += idle_s
            tail = dur * (max(stall, 1.0) - 1.0)
            t0 = t
            t += dur + tail
            record_span(t0, t0 + dur, busy_w * dur)
            record_span(t0 + dur, t, idle_w * tail)
            if cap_ledger is not None and cap_ledger.violates(t0 + dur,
                                                              cap_w=env_cap):
                cap_violations += 1
            if bud_ledger is not None and bud_ledger.violates(t0 + dur):
                cap_violations += 1
            if gov is not None:
                gov.update(t, cap_eff)
            self.policy.on_busy(kind, dur + tail)
            return dur + tail, busy_w * dur + idle_w * tail

        def shed_scan() -> None:
            """Deadline re-check over the whole ready queue: drop requests
            that became infeasible while waiting, before any prefill energy
            is spent on them."""
            nonlocal shed
            if not self.shed:
                return
            kept = []
            for r in ready:
                if self._infeasible(t, len(r.prompt), r.new_tokens - 1,
                                    r.arrival_s, deadlines[r.rid]):
                    recs[r.rid].shed = True
                    shed += 1
                else:
                    kept.append(r)
            if len(kept) != len(ready):
                ready.clear()
                ready.extend(kept)

        def quarantine(slot: int) -> None:
            """Retire a poisoned slot; nothing from the faulted tick was
            committed. The request re-enters through the retry queue after
            a backoff delay, or is failed past the retry budget."""
            nonlocal quarantined, failed
            info = pool.slots[slot]
            rid, budget, emitted = info.rid, info.budget, info.emitted
            pool.retire(slot)
            if self.drafter is not None:
                self.drafter.forget(rid)
            if self.throttle is not None:
                self.throttle.forget(rid)
            quarantined += 1
            a = attempts.get(rid, 0)
            if a >= self.retry.max_restarts:
                recs[rid].failed = True
                failed += 1
                return
            attempts[rid] = a + 1
            retry_q.append({"rid": rid, "ready_at": t + self.retry.delay(a),
                            "budget": budget, "emitted": emitted})

        def admit_retry(e: dict) -> None:
            """Re-admit a quarantined or preempted request. Quarantine and
            recompute-restore entries do a blocking re-prefill of the
            request's COMMITTED context with the last committed token as the
            next decode input — the greedy continuation is token-for-token
            what an undisturbed run emits. Swap-restore entries re-map the
            host image into fresh pages (bit-identical bytes) and pay only
            the transfer time."""
            nonlocal t, shed, retried, preempt_waste
            rid = e["rid"]
            r, rec = by_rid[rid], recs[rid]
            emitted, budget = e["emitted"], e["budget"]
            image = e.get("image")
            ctx_len = len(r.prompt) + emitted - 1
            if self._infeasible(t, ctx_len, budget - emitted,
                                r.arrival_s, deadlines[rid]):
                rec.shed = True  # shed at retry: the sunk energy is wasted
                shed += 1
                return
            slot = pool.next_free()
            if image is not None:
                dt = image["bytes"] / (chip.reload_bw * chips)
                pool.swap_in(slot, image)
                ej = chip.p_idle_w * chips * dt
                record_span(t, t + dt, ej)
                t += dt
                self.policy.on_busy("swap", dt)
                rec.energy_j += ej
                preempt_waste += ej
            else:
                context = np.asarray(list(r.prompt) + rec.tokens[:emitted - 1],
                                     np.int32)
                tp = self.cal.prefill_s(1, len(context))
                next_tok = rec.tokens[emitted - 1]
                if self.execute:
                    self.engine.resume_into_slot(pool, slot, context, rid=rid,
                                                 budget=budget, emitted=emitted,
                                                 next_tok=next_tok)
                else:
                    pool.admit_virtual(slot, rid=rid, pos=len(context),
                                       budget=budget, emitted=emitted)
                    pool.tok[slot] = next_tok
                _, ej = busy_tick("prefill", tp, self.prefill_util)
                rec.energy_j += ej
                if e.get("preempt"):
                    preempt_waste += ej
            pool.slots[slot].tier = tiers[rid]
            if not e.get("preempt"):
                rec.retries += 1
                retried += 1
            if self.drafter is not None:
                self.drafter.begin(rid, list(r.prompt) + rec.tokens[:emitted])
            if self.throttle is not None:
                self.throttle.begin(rid)

        def victim_candidates(tier_only: str | None = None) -> list[dict]:
            """Per-decoding-slot facts the ``PreemptionPolicy`` ranks on.
            Poisoned (tainted) slots are excluded — they are about to be
            quarantined anyway and cannot be swapped."""
            out = []
            for s in pool.decoding_slots():
                info = pool.slots[s]
                if paged and s in pool._slot_tainted:
                    continue
                if tier_only is not None and info.tier != tier_only:
                    continue
                dl = deadlines.get(info.rid)
                slack = (recs[info.rid].arrival_s + dl - t
                         if dl is not None else math.inf)
                out.append({"slot": s, "tier": info.tier, "slack": slack,
                            "pages": int(pool._owned[s]),
                            "progress": info.emitted / max(info.budget, 1)})
            return out

        def preempt_slot(slot: int) -> None:
            """Preempt a healthy decoding slot: the fixed cost model picks
            swap (2 transfers at reload bandwidth) vs recompute (one
            re-prefill of the committed context); the request re-enters
            through the retry queue at once, WITHOUT charging its retry
            budget — preemption is the scheduler's doing, not a fault."""
            nonlocal t, preempted, swapped, recomputed, preempt_waste
            nonlocal progressed
            info = pool.slots[slot]
            rid, budget, emitted = info.rid, info.budget, info.emitted
            rec = recs[rid]
            image = None
            if self.swap:
                sbytes = pool.swap_image_bytes(slot)
                t_swap = 2 * sbytes / (chip.reload_bw * chips)
                t_rec = self.cal.prefill_s(1, len(by_rid[rid].prompt)
                                           + emitted - 1)
                if t_swap <= t_rec:
                    image = pool.swap_out(slot)
                    dt = image["bytes"] / (chip.reload_bw * chips)
                    ej = chip.p_idle_w * chips * dt
                    record_span(t, t + dt, ej)
                    t += dt
                    self.policy.on_busy("swap", dt)
                    rec.energy_j += ej
                    preempt_waste += ej
                    swapped += 1
            if image is None:
                pool.retire(slot)
                recomputed += 1
            preempted += 1
            progressed = True  # state changed; never an idle-gap this tick
            if self.drafter is not None:
                self.drafter.forget(rid)
            if self.throttle is not None:
                self.throttle.forget(rid)
            retry_q.append({"rid": rid, "ready_at": t, "budget": budget,
                            "emitted": emitted, "image": image,
                            "preempt": True})

        def relieve_pressure(span: int) -> None:
            """The pre-tick WATERMARK: the worst-case page growth of this
            decode/verify tick (every decoding slot's write span) must fit
            in free + evictable pages net of admitting-group reservations;
            demand past the mark preempts policy-ranked victims BEFORE the
            tick, so mid-tick exhaustion is the exception, not the rule."""
            while True:
                decoding = pool.decoding_slots()
                if len(decoding) <= 1:
                    return  # a lone slot self-resolves via the typed path
                demand = sum(
                    pool.blocks_needed(s, pool.slots[s].pos,
                                       pool.slots[s].pos + span)
                    for s in decoding)
                avail = (pool.pages.free_count + pool._evictable()
                         - pool.reserved_admitting())
                if demand <= avail:
                    return
                cands = victim_candidates()
                if not cands:
                    return
                preempt_slot(self.preempter.rank(cands)[0]["slot"])

        def emergency_preempt() -> bool:
            """``PageExhausted`` escaped a tick despite the watermark (stale
            evictable estimate, pressure fault, no preempter configured):
            preempt the best victim and let the loop retry the tick. Typed
            recovery — the crash-era RuntimeError is gone."""
            cands = victim_candidates()
            if not cands:
                return False
            pol = self.preempter or PreemptionPolicy()
            preempt_slot(pol.rank(cands)[0]["slot"])
            return True

        def promote_latency() -> None:
            """Stable-partition the ready queue: latency-tier requests (in
            arrival order) ahead of batch-tier. Only active with a
            preemption policy, so tierless runs keep exact FIFO order."""
            if not any(tiers[r.rid] == "latency" for r in ready):
                return
            lat = [r for r in ready if tiers[r.rid] == "latency"]
            bat = [r for r in ready if tiers[r.rid] != "latency"]
            ready.clear()
            ready.extend(lat + bat)

        def release_press() -> None:
            nonlocal press_pins
            if press_pins:
                pool.unpin_pages(press_pins)
                press_pins = []

        def observe_tick(dur: float) -> None:
            nonlocal stragglers
            if self.detector is not None and self.detector.observe(dur):
                stragglers += 1
                self.detector.reset()

        while self.completed + shed + failed < n:
            guard += 1
            assert guard <= guard_max, "scheduler failed to make progress"
            progressed = False
            ingest()
            shed_scan()

            # quarantined/preempted requests re-admit FIRST — they hold
            # committed work (re-admission needs the context's worst-case
            # page budget too: s0 = prompt + already-emitted tokens,
            # budget = the remainder). With tiers on, latency-tier entries
            # restore ahead of batch-tier ones.
            while pool.free_count and retry_q:
                scan = (sorted(range(len(retry_q)),
                               key=lambda j: tiers[retry_q[j]["rid"]] != "latency")
                        if self.preempter is not None else range(len(retry_q)))
                idx = next(
                    (j for j in scan
                     if retry_q[j]["ready_at"] <= t
                     and not gov_defers(retry_q[j]["rid"])
                     and pool.can_admit(
                         len(by_rid[retry_q[j]["rid"]].prompt)
                         + retry_q[j]["emitted"] - 1,
                         retry_q[j]["budget"] - retry_q[j]["emitted"] + 1)),
                    None)
                if idx is None:
                    break
                e = retry_q.pop(idx)
                try:
                    admit_retry(e)
                except PageExhausted:
                    # evictable estimate went stale: wait for pages
                    retry_q.insert(0, e)
                    break
                ingest()

            if gov is not None and paged and gov.take_preempt():
                # brownout ladder level "preempt": shed watts by shedding
                # batch-tier occupancy — one policy-ranked victim per
                # escalation, consumed at a tick boundary (never mid-tick)
                cands = victim_candidates(tier_only="batch")
                if cands:
                    pol = self.preempter or PreemptionPolicy()
                    preempt_slot(pol.rank(cands)[0]["slot"])

            if self.preempter is not None:
                # SLO tiers: latency-tier arrivals go first, and a latency
                # head that cannot admit may preempt batch-tier slots
                # instead of queueing behind them
                promote_latency()
                if ready and tiers[ready[0].rid] == "latency":
                    head = ready[0]
                    while (not pool.can_admit(len(head.prompt),
                                              head.new_tokens,
                                              shared_len=self._prefix_len(head))):
                        cands = victim_candidates(tier_only="batch")
                        if not cands:
                            break
                        preempt_slot(self.preempter.rank(cands)[0]["slot"])

            if (self.prefill_chunk is None or chunk_disabled
                    or (gov is not None and not gov.chunk_ok())):
                # BLOCKING admissions: fill free slots from the ready queue;
                # each prefill stalls the whole pool. can_admit covers the
                # free-slot check and (paged) the head's worst-case page
                # budget — admission stays FIFO, so a page-starved head
                # waits rather than being jumped
                while (ready and not gov_defers(ready[0].rid)
                       and pool.can_admit(len(ready[0].prompt),
                                          ready[0].new_tokens)):
                    r = ready.popleft()
                    rec = recs[r.rid]
                    # t advanced during earlier admissions — re-check
                    if self._infeasible(t, len(r.prompt), r.new_tokens - 1,
                                        r.arrival_s, deadlines[r.rid]):
                        rec.shed = True
                        shed += 1
                        continue
                    slot = pool.next_free()
                    tp = self.cal.prefill_s(1, len(r.prompt))
                    if self.execute:
                        try:
                            first = self.engine.prefill_into_slot(
                                pool, slot, r.prompt, rid=r.rid,
                                budget=r.new_tokens)
                        except PageExhausted:
                            # can_admit's evictable estimate went stale mid-
                            # scan; the pool unwound cleanly — wait for pages
                            ready.appendleft(r)
                            break
                    else:
                        first = 0
                        pool.admit_virtual(slot, rid=r.rid, pos=len(r.prompt),
                                           budget=r.new_tokens)
                    pool.slots[slot].tier = tiers[r.rid]
                    rec.admit_s = t
                    _, ej = busy_tick("prefill", tp, self.prefill_util)
                    rec.energy_j += ej
                    rec.tokens.append(first)
                    if self.drafter is not None:
                        self.drafter.begin(r.rid, list(r.prompt) + [first])
                    if self.throttle is not None:
                        self.throttle.begin(r.rid)
                    self.admitted += 1
                    self._maybe_finish(slot, rec, t, deadlines[r.rid])
                    ingest()
            elif group is None and ready and pool.free_count:
                # CHUNKED admission: reserve slots for the maximal FIFO run
                # of waiting same-prompt-length (and, under paged prefix
                # sharing, same shared-prefix-length) requests — one batched
                # prefill. Each member reserves AS it joins, so the paged
                # pool's page-budget accounting sees the cumulative claim
                # and can_admit stops the run before pages oversubscribe.
                m0 = self._prefix_len(ready[0])
                g: list[Request] = []
                slots: list[int] = []
                while (ready and pool.free_count
                       and not gov_defers(ready[0].rid)
                       and (not g
                            or (len(ready[0].prompt) == len(g[0].prompt)
                                and self._prefix_len(ready[0]) == m0))
                       and pool.can_admit(len(ready[0].prompt),
                                          ready[0].new_tokens,
                                          shared_len=m0)):
                    r = ready.popleft()
                    slot = pool.next_free()
                    pool.reserve(slot, rid=r.rid, s0=len(r.prompt),
                                 budget=r.new_tokens, shared_len=m0)
                    pool.slots[slot].tier = tiers[r.rid]
                    g.append(r)
                    slots.append(slot)
                    recs[r.rid].admit_s = t
                    self.admitted += 1
                if g:
                    prompts = np.stack([r.prompt for r in g]).astype(np.int32)
                    rids = [r.rid for r in g]
                    budgets = [r.new_tokens for r in g]
                    group_fails = 0
                    group_spent_ok = 0.0
                    if self.execute:
                        group = self.engine.begin_chunked_prefill(
                            pool, slots, prompts, rids=rids, budgets=budgets)
                    else:
                        group = ChunkedPrefillState(prompts=prompts, rids=rids,
                                                    budgets=budgets, slots=slots)

            if group is not None:
                # PREFILL: advance the admitting group by one chunk; the
                # chunk's energy is split over the group's requests
                k = len(group.rids)
                ttok = min(self.prefill_chunk, group.s0 - group.pos)
                fail = inj.chunk_fails() if inj is not None else False
                stall = inj.stall() if inj is not None else 1.0
                therm = inj.thermal() if inj is not None else None
                if therm is not None:
                    env.throttle(t, therm,
                                 self.faults.therm_ticks * self.cal.step_s())
                tp, te = busy_tick("prefill", self.cal.chunk_s(k, ttok),
                                   self.prefill_util, stall)
                self.chunks += 1
                observe_tick(tp)
                share = te / k
                for rid in group.rids:
                    recs[rid].energy_j += share
                progressed = True
                if fail:
                    # the tick's work is lost: the group cache did not advance
                    chunk_faults += 1
                    group_fails += 1
                    for rid in group.rids:
                        recs[rid].waste_j += share
                    if group_fails > self.retry.max_restarts:
                        # past the retry budget: DEGRADE — drop the group's
                        # reservations, requeue its members for blocking
                        # admission, and keep chunking off for this run
                        degraded += 1
                        chunk_disabled = True
                        for rid in group.rids:
                            recs[rid].waste_j += group_spent_ok / k
                        if self.execute:
                            # also releases any pinned shared-prefix pages
                            self.engine.cancel_chunked_prefill(pool, group)
                        else:
                            for slot in group.slots:
                                pool.retire(slot)
                        self.admitted -= k  # they re-admit through blocking
                        for r in reversed([by_rid[rid] for rid in group.rids]):
                            ready.appendleft(r)
                        group = None
                else:
                    group_fails = 0
                    group_spent_ok += share * k
                    if self.execute:
                        self.engine.chunked_prefill_step(group, self.prefill_chunk)
                    else:
                        group.pos += ttok
                    if group.done:
                        if self.execute:
                            try:
                                first = self.engine.finish_chunked_prefill(
                                    pool, group)
                            except PageExhausted:
                                # the group's delta blocks cannot land (the
                                # atomic pre-check caught it before touching
                                # any slot): DEGRADE to blocking admission,
                                # exactly like a chunk-fault budget blowout
                                degraded += 1
                                chunk_disabled = True
                                for rid in group.rids:
                                    recs[rid].waste_j += group_spent_ok / k
                                self.engine.cancel_chunked_prefill(pool, group)
                                self.admitted -= k
                                for r in reversed(
                                        [by_rid[rid] for rid in group.rids]):
                                    ready.appendleft(r)
                                group = None
                                continue
                        else:
                            first = np.zeros(k, np.int32)
                            for j, slot in enumerate(group.slots):
                                pool.activate(slot, None, rid=group.rids[j],
                                              pos=group.s0,
                                              budget=group.budgets[j],
                                              first_tok=0)
                        for j, rid in enumerate(group.rids):
                            rec = recs[rid]
                            pool.slots[group.slots[j]].tier = tiers[rid]
                            rec.tokens.append(int(first[j]))
                            if self.drafter is not None:
                                self.drafter.begin(
                                    rid, list(group.prompts[j]) + [int(first[j])])
                            if self.throttle is not None:
                                self.throttle.begin(rid)
                            self._maybe_finish(group.slots[j], rec, t,
                                               deadlines[rid])
                        group = None

            # sample occupancy at its per-tick high-water mark (admissions
            # done, nothing retired yet this tick)
            peak_active = max(peak_active, pool.active_count)

            decoding = pool.decoding_slots()
            spec_k = 0
            win: dict[int, int] | None = None
            if decoding and self.speculate_k:
                # the brownout ladder caps windows from above (halved at
                # spec_half, 0 at spec_off and beyond) — BATCH-tier slots
                # only: latency-tier work is the last thing the ladder
                # touches, so its windows ride through undegraded
                k_gov = (gov.spec_cap(self.speculate_k) if gov is not None
                         else self.speculate_k)
                if gov is not None or self.throttle is not None:
                    # per-slot windows; the pool's verify width is their max
                    # (windows move in powers of two, so the K-keyed verify
                    # graphs number at most log2(K) + 1)
                    win = {}
                    for s in decoding:
                        rid = pool.slots[s].rid
                        k = (self.speculate_k if tiers[rid] == "latency"
                             else k_gov)
                        if self.throttle is not None:
                            k = min(self.throttle.window(rid), k)
                        win[s] = k
                    spec_k = max(win.values())
                    if spec_k == 0 and self.throttle is not None:
                        throttled += 1  # whole pool stalled: plain tick
                else:
                    spec_k = k_gov

            if paged and decoding:
                # MEMORY PRESSURE phase: the page-pressure fault may pin
                # free pages out for this tick, then the watermark preempts
                # victims until the tick's worst-case growth fits
                if inj is not None:
                    stolen = inj.press()
                    if stolen:
                        press_pins = pool.pin_free_pages(stolen)
                if force_plain:
                    spec_k = 0  # one-shot: retry the failed tick unspeculated
                if self.preempter is not None:
                    relieve_pressure(spec_k + 1)
                    decoding = pool.decoding_slots()
            force_plain = False

            if spec_k and decoding:
                # SPECULATIVE DECODING: draft K candidates per decoding slot
                # (admitting slots stay out of the verify mask), score every
                # slot's K+1 window in ONE verify pass, commit the accepted
                # prefixes. The tick is charged like a decode step plus the
                # per-candidate increment, amortized by tokens committed.
                victims = inj.poison_victims(decoding) if inj is not None else []
                stall = inj.stall() if inj is not None else 1.0
                therm = inj.thermal() if inj is not None else None
                if therm is not None:
                    env.throttle(t, therm,
                                 self.faults.therm_ticks * self.cal.step_s())
                if victims and self.execute:
                    for s in victims:
                        self.engine.poison_slot(pool, s)
                drafts = np.zeros((pool.max_batch, spec_k), np.int32)
                for slot in decoding:
                    drafts[slot] = self.drafter.propose(
                        pool.slots[slot].rid)[:spec_k]
                if self.execute:
                    try:
                        toks, acc, fin = self.engine.masked_speculative_step(
                            pool, drafts)
                    except PageExhausted:
                        # verify tail blocks outran the pool mid-tick (the
                        # crash-era RuntimeError path): preempt one victim,
                        # retry the tick as plain decode (within-reservation
                        # demand, always satisfiable after the preempt)
                        if not emergency_preempt():
                            tq = [s for s in pool.decoding_slots()
                                  if s in pool._slot_tainted]
                            if tq:
                                quarantine(tq[0])
                        force_plain = True
                        release_press()
                        continue
                else:  # the virtual model's greedy chain is all zeros
                    toks = np.zeros((pool.max_batch, spec_k + 1), np.int32)
                    acc = np.cumprod(drafts == 0, axis=1).sum(axis=1)
                    fin = np.ones(pool.max_batch, bool)
                    fin[victims] = False
                util = len(decoding) / pool.max_batch
                ts, tick_e = busy_tick("verify", self.cal.verify_s(spec_k),
                                       util, stall)
                self.verify_ticks += 1
                observe_tick(ts)
                # a slot never overshoots its budget (acceptance past the
                # remaining budget is truncated, the slot retires mid-verify)
                # nor its own throttle window; a quarantined slot's discarded
                # work weighs like one token in the amortization
                caps = {s: (win[s] if win is not None else spec_k)
                        for s in decoding}
                emit = {s: (1 if not fin[s] else
                            min(int(acc[s]) + 1, caps[s] + 1,
                                pool.slots[s].budget - pool.slots[s].emitted))
                        for s in decoding}
                total = sum(emit.values())
                for slot in decoding:
                    info = pool.slots[slot]
                    rec = recs[info.rid]
                    share = tick_e * emit[slot] / total
                    rec.energy_j += share
                    if not fin[slot]:
                        rec.waste_j += share
                        quarantine(slot)
                        continue
                    n_tok = emit[slot]
                    out = toks[slot, :n_tok].tolist()
                    pool.advance(slot, n_tok, int(toks[slot, n_tok - 1]))
                    self.drafter.observe(info.rid, out)
                    if self.throttle is not None:
                        self.throttle.observe(
                            info.rid, min(int(acc[slot]), caps[slot]), caps[slot])
                    rec.tokens.extend(out)
                    self.accepted_tokens += n_tok
                    self._maybe_finish(slot, rec, t, deadlines[info.rid])
                progressed = True
            elif decoding:
                # DECODING: one masked step over the pool at measured occupancy
                victims = inj.poison_victims(decoding) if inj is not None else []
                stall = inj.stall() if inj is not None else 1.0
                therm = inj.thermal() if inj is not None else None
                if therm is not None:
                    env.throttle(t, therm,
                                 self.faults.therm_ticks * self.cal.step_s())
                if victims and self.execute:
                    for s in victims:
                        self.engine.poison_slot(pool, s)
                util = len(decoding) / pool.max_batch
                if self.execute:
                    try:
                        nxt, fin = self.engine.masked_decode_step(pool)
                    except PageExhausted:
                        if not emergency_preempt():
                            tq = [s for s in pool.decoding_slots()
                                  if s in pool._slot_tainted]
                            if tq:
                                quarantine(tq[0])
                        release_press()
                        continue
                else:
                    nxt = np.zeros(pool.max_batch, np.int32)
                    fin = np.ones(pool.max_batch, bool)
                    fin[victims] = False
                ts, te = busy_tick("decode", self.cal.step_s(), util, stall)
                observe_tick(ts)
                share = te / len(decoding)
                for slot in decoding:
                    info = pool.slots[slot]
                    rec = recs[info.rid]
                    rec.energy_j += share
                    if not fin[slot]:
                        rec.waste_j += share
                        quarantine(slot)
                        continue
                    tok = int(nxt[slot])
                    pool.advance(slot, 1, tok)
                    rec.tokens.append(tok)
                    if self.speculate_k and self.drafter is not None:
                        # throttled-to-0 tick: keep the drafter's history in
                        # sync so a re-opened window drafts from truth
                        self.drafter.observe(info.rid, [tok])
                    self._maybe_finish(slot, rec, t, deadlines[info.rid])
                progressed = True

            release_press()

            if not progressed and group is None and (i < n or retry_q):
                # IDLE/OFF: pool drained — the online policy owns the gap up
                # to the next event (an arrival, or a retry backoff expiry).
                # (everything admissible by t was admitted above, so the gap
                # is strictly positive)
                pending = []
                if i < n:
                    pending.append(reqs[i].arrival_s)
                if retry_q:
                    pending.append(min(e["ready_at"] for e in retry_q))
                target = min(pending)
                gap = target - t
                assert gap > 0
                out = self.policy.on_gap(gap)
                gap_energy += out.energy_j
                reloads += int(out.slept)
                gap_t0 = t
                t = target + out.wake_s
                record_span(gap_t0, t, out.energy_j)
                if gov is not None:
                    # quiet spells de-escalate the ladder
                    gap_cap = env.cap_w(t) if env is not None else math.inf
                    if bud_ledger is not None:
                        gap_cap = min(gap_cap, bud_ledger.cap_w)
                    gov.update(t, gap_cap)

            peak_active = max(peak_active, pool.active_count)

            # conservation: every request is in exactly one place
            assert (self.completed + shed + failed + pool.active_count
                    + len(retry_q) + len(ready) + (n - i) == n), \
                "request leak: terminal + in-flight + queued != total"

        records = [recs[r.rid] for r in reqs]
        energy = (self.profile.e_cfg_j  # the one true initial configuration
                  + sum(rec.energy_j for rec in records) + gap_energy
                  + forgone_j)
        finished = [rec.finish_s for rec in records
                    if not math.isnan(rec.finish_s)]
        makespan = (max(finished) if finished else t) - reqs[0].arrival_s
        # wasted energy: everything spent on a request that never completed
        # on time (shed mid-retry, failed, or missed its deadline), plus the
        # fault-discarded tick shares of requests that did complete
        wasted = sum(rec.energy_j if (rec.shed or rec.failed or rec.missed)
                     else rec.waste_j for rec in records)
        return ServeReport(mode, records, energy, makespan, reloads,
                           sum(rec.missed for rec in records), chunks=self.chunks,
                           verify_ticks=self.verify_ticks,
                           accepted_tokens=self.accepted_tokens,
                           shed=shed, retried=retried, quarantined=quarantined,
                           failed=failed, chunk_faults=chunk_faults,
                           stragglers=stragglers, degraded=degraded,
                           throttled_ticks=throttled, wasted_energy_j=wasted,
                           peak_active=peak_active,
                           shared_hit_pages=getattr(pool, "shared_hit_pages", 0),
                           cow_copies=getattr(pool, "cow_copies", 0),
                           evictions=getattr(pool, "evictions", 0),
                           preempted=preempted, swapped=swapped,
                           recomputed=recomputed,
                           preempt_wasted_j=preempt_waste,
                           brownout_ticks=(gov.brownout_ticks
                                           if gov is not None else 0),
                           brownout_transitions=(gov.transitions
                                                 if gov is not None else 0),
                           cap_violation_ticks=cap_violations,
                           brownout_forgone_j=forgone_j,
                           level_dwell=(tuple(gov.dwell)
                                        if gov is not None else ()),
                           peak_window_w=(cap_ledger.peak_window_w
                                          if cap_ledger is not None else 0.0),
                           peak_budget_window_j=(
                               bud_ledger.peak_window_j
                               if bud_ledger is not None else 0.0))


# ---------------------------------------------------------------------------
# Static-batch baseline (the path this subsystem replaces)
# ---------------------------------------------------------------------------
def run_static_batches(engine: InferenceEngine, requests: Sequence[Request], *,
                       policy: str | DutyCyclePolicy = "adaptive",
                       chip: H100Chip = DEFAULT_CHIP, chips: int = 1,
                       batch: int | None = None, flush_s: float = 1.0,
                       execute: bool = True, calibration=None,
                       policy_kw: dict | None = None) -> ServeReport:
    """Fixed-batch lockstep serving over the same request stream.

    Requests queue until ``batch`` of them have arrived (or ``flush_s`` has
    passed since the head request arrived), then the whole cohort runs as
    one padded batch: every member pays the cohort's longest prompt and
    largest token budget, and nobody finishes until the cohort does. The
    fixed-batch engine computes its full padded batch shape every step —
    lockstep padding is the point — so cohort runs are charged at full
    utilization (matching ``WorkloadAwareServer``'s p_active·t_inf ledger),
    whereas the continuous scheduler's power follows measured slot occupancy
    (slot compaction). Gaps between cohorts go through the same online
    duty-cycle policies as the continuous scheduler, so the comparison
    isolates BATCHING, not duty cycling.
    """
    if not execute and calibration is None:
        raise ValueError("execute=False needs an explicit calibration")
    cal = calibration if calibration is not None else EngineCalibration(engine)
    batch = batch or engine.sc.max_batch
    reqs = sorted(requests, key=lambda r: r.arrival_s)
    if not reqs:
        return ServeReport("static", [], 0.0, 0.0, 0, 0)
    profile = _gpu_profile(cal.step_s(), chip, chips, engine.cfg)
    pol = (policy if isinstance(policy, DutyCyclePolicy)
           else make_policy(policy, profile, device=engine.device, **(policy_kw or {})))

    recs = []
    energy = profile.e_cfg_j
    reloads = 0
    t_free = reqs[0].arrival_s
    n, i = len(reqs), 0
    while i < n:
        cutoff = max(reqs[i].arrival_s + flush_s, t_free)
        j = i + 1
        while j < n and j - i < batch and reqs[j].arrival_s <= cutoff:
            j += 1
        cohort = reqs[i:j]
        start = max(t_free, cohort[-1].arrival_s if len(cohort) == batch else cutoff)
        idle = start - t_free
        if idle > 0:
            out = pol.on_gap(idle)
            energy += out.energy_j
            reloads += int(out.slept)
            start += out.wake_s

        s_pad = max(len(r.prompt) for r in cohort)
        k_max = max(r.new_tokens for r in cohort)
        t_run = cal.prefill_s(len(cohort), s_pad) + (k_max - 1) * cal.step_s()
        e_run = chip.step_power(1.0) * chips * t_run
        out_toks = None
        if execute:
            prompts = np.zeros((len(cohort), s_pad), np.int32)
            for b, r in enumerate(cohort):
                prompts[b, : len(r.prompt)] = r.prompt  # right-padded lockstep
            out_toks = engine.generate(prompts, k_max)
        finish = start + t_run
        for b, r in enumerate(cohort):
            rec = RequestRecord(r.rid, r.arrival_s, len(r.prompt), r.new_tokens,
                                admit_s=start, finish_s=finish,
                                energy_j=e_run / len(cohort))
            rec.tokens = (out_toks[b, : r.new_tokens].tolist() if out_toks is not None
                          else [0] * r.new_tokens)
            rec.missed = r.deadline_s is not None and rec.latency_s > r.deadline_s
            recs.append(rec)
        t_free = finish
        i = j

    makespan = t_free - reqs[0].arrival_s
    energy += sum(r.energy_j for r in recs)
    return ServeReport("static", recs, energy, makespan, reloads,
                       sum(r.missed for r in recs))
