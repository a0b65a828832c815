"""Serving launcher: continuous-batching scheduler with online duty cycling
(RQ2 on the card), plus the legacy offline strategy comparison.

Runs on the card (``--device`` unset means CUDA, and fails without one)
unless ``--device cpu`` asks for the CPU.  The scheduler's costs are
measured on that device (``EngineCalibration``) and its energy ledger uses
``H100Chip``'s constants.

Modes:
  continuous   request-level scheduler: admission into free slots mid-decode
               with BLOCKING prefill, one masked decode step per tick (a
               replayed CUDA graph on the card), online streaming-τ duty
               cycling between queue drains
               (default)
  chunked      continuous scheduling with CHUNKED admission: FIFO
               same-length groups advance --prefill-chunk prompt tokens per
               tick between decode steps, so a long prompt never freezes
               the pool
  speculative  continuous scheduling with SPECULATIVE decode ticks: an
               n-gram drafter proposes --speculate-k candidates per slot
               and one batched verify pass commits the greedy-matched
               prefix — several tokens per tick on repetitive output,
               token-for-token identical to plain decode
  compare      static baseline vs continuous vs chunked vs speculative,
               same stream
  strategies   the offline gap-trace strategy comparison
               (WorkloadAwareServer)

Memory (any scheduler mode):
  --paged           paged KV cache (serving/pages.py): slots map logical
                    blocks of --page-size cache rows onto shared physical
                    pages instead of owning a max_len rectangle; admission
                    is page-budget aware, speculative verify needs no
                    spec_slack spare rows
  --page-size       cache rows per physical page (default 16)
  --share-prefix    copy-on-write shared-prefix reuse: admissions whose
                    prompt matches a registered block-aligned prefix map
                    the resident pages read-only and prefill only the delta
                    (paged only; disabled for SSM/hybrid/frontend families)
  --page-budget     override the physical page count (default: contiguous
                    parity); smaller budgets over-commit the pool and
                    exercise the watermark/preemption path
  In compare mode a fifth row serves the stream on a paged pool and the
  table reports the device bytes of both cache layouts plus the preemption
  column (preempted/swapped/recomputed).

Memory pressure (paged only):
  --preempt-policy  preempt-and-restore instead of crashing on page
                    exhaustion: victims picked by SLO tier + deadline slack
                    ("tiered"), page footprint ("footprint"), or slack
                    alone ("slack"); "none" (default) keeps the emergency
                    shed-only behaviour
  --swap/--no-swap  allow swap-out restore (pages copied to a host buffer
                    and re-mapped bit-identically) when the cost model
                    prefers it over re-prefill recompute
  --tier-mix        fraction of requests on the "latency" SLO tier (drawn
                    from a separate seeded generator; 0 = all batch tier);
                    latency arrivals may preempt batch-tier slots instead
                    of queueing

Robustness (any scheduler mode):
  --fault-profile   inject deterministic faults: a named profile
                    ("none"/"light"/"heavy") or a spec string like
                    "nan=0.05,stall=0.02,stallx=8,chunk=0.1,max=20";
                    poisoned slots are quarantined and retried from their
                    last committed token, token-for-token identical output
  --retry-budget    max re-prefills per quarantined request before it is
                    marked failed (exponential backoff between attempts)
  --shed            deadline-aware admission control: shed requests the
                    fixed cost model says cannot finish inside --deadline
  --deadline        per-request latency deadline in seconds (0 = none);
                    without --shed, late requests are only counted missed
  --queue-limit     ready-queue backpressure: shed arrivals beyond this
                    depth even without deadlines
  --load flash      flash-crowd stream (baseline Poisson + one overload
                    spike window) — the shedding stress regime

Power envelope (any scheduler mode; see docs/serving.md):
  --power-cap       sustained power cap in watts over the whole run
                    (0 = uncapped); the compliance ledger asserts no
                    rolling window ever exceeds it
  --power-faults    seeded thermal-throttle events drawn from the fault
                    axis, e.g. "therm=0.1,thermf=0.5,thermt=24" — clock
                    drops to the fraction, tick times stretch by 1/f,
                    dynamic power scales by f (add to --fault-profile)
  --brownout        how the scheduler meets a power deficit: "ladder"
                    (hysteretic degradation ladder — spec window shrink,
                    spec off, blocking admission, Slow-Down pacing,
                    batch-tier preemption, batch-tier shedding; latency
                    tier touched last), "uniform" (naive: stretch every
                    busy tick with idle), or "off"
  --energy-budget   hard energy budget in joules per --budget-window
                    seconds (0 = none); the ledger GUARANTEES no window
                    exceeds it, inserting idle when needed
  --budget-window   the energy-budget window length in seconds

Examples:
  python -m repro_torch.launch.serve --arch granite-3-8b --load bursty --n 60
  python -m repro_torch.launch.serve --arch granite-3-8b --mode chunked --prefill-chunk 8
  python -m repro_torch.launch.serve --arch whisper-tiny --mode speculative --speculate-k 4
  python -m repro_torch.launch.serve --arch granite-3-8b --mode compare --load poisson
  python -m repro_torch.launch.serve --arch granite-3-8b --mode compare --paged --n 12
  python -m repro_torch.launch.serve --arch granite-3-8b --mode strategies --trace bursty
  python -m repro_torch.launch.serve --arch whisper-tiny --load flash --shed --deadline 0.5
  python -m repro_torch.launch.serve --arch whisper-tiny --fault-profile light --retry-budget 4
  python -m repro_torch.launch.serve --arch whisper-tiny --power-cap 300 --brownout ladder \\
      --tier-mix 0.3 --power-faults therm=0.1,thermf=0.5,thermt=24
  python -m repro_torch.launch.serve --arch granite-3-8b --mode compare --n 12 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch.configs import get_reduced_config, list_archs
from repro_torch.core.retry import RestartPolicy
from repro_torch.core.workload import bursty_trace, irregular_trace, regular_trace
from repro_torch.kernels.runtime import resolve_device
from repro_torch.serving.engine import InferenceEngine, ServeConfig, WorkloadAwareServer
from repro_torch.serving.faults import make_profile
from repro_torch.serving.kv_cache import cache_bytes, paged_cache_bytes
from repro_torch.serving.power import CapWindow, PowerEnvelope
from repro_torch.serving.load import (
    bursty_stream_for_service,
    diurnal_stream,
    flash_crowd_stream,
    mean_service_s,
    poisson_stream,
)
from repro_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    EngineCalibration,
    run_static_batches,
)


def _make_stream(args, cfg, cal):
    """Arrival rates scaled from the measured step costs so the stream
    exercises both queue pressure and duty-cycle-relevant quiets.

    Speculative modes default to REPETITIVE (period-4 tiled) prompts — the
    templated-workload regime the n-gram drafter exploits; i.i.d.-random
    prompts leave it only the model's own output repetitiveness."""
    service = mean_service_s(cal)
    period = args.prompt_period
    if period < 0:
        period = 4 if args.mode in ("speculative", "compare") else 0
    kw = dict(seed=args.seed, vocab_size=cfg.vocab_size,
              prompt_lens=(4, 8), new_tokens=(4, 24),
              prompt_period=period or None, tier_mix=args.tier_mix)
    deadline = args.deadline if args.deadline > 0 else None
    if args.load == "poisson":
        return poisson_stream(args.n, rate_hz=0.5 / service,
                              deadline_s=deadline, **kw)
    if args.load == "diurnal":
        return diurnal_stream(args.n, base_rate_hz=0.1 / service,
                              peak_rate_hz=1.0 / service,
                              period_s=40 * service, deadline_s=deadline, **kw)
    if args.load == "flash":
        # spike at many-x the pool's service rate: overload by construction
        return flash_crowd_stream(args.n, base_rate_hz=0.2 / service,
                                  spike_rate_hz=8.0 * args.batch / service,
                                  spike_start_s=10 * service,
                                  spike_len_s=10 * service,
                                  deadline_s=deadline, **kw)
    return bursty_stream_for_service(cal, args.n, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--mode", default="continuous",
                    choices=("continuous", "chunked", "speculative", "compare",
                             "strategies"))
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per chunked-prefill tick; admission "
                         "batches same-length arrivals into one prefill call "
                         "(modes: chunked, compare)")
    ap.add_argument("--prompt-period", type=int, default=-1,
                    help="tile prompts from a per-request base pattern of "
                         "this length (repetitive/templated workloads); "
                         "0 = i.i.d. random prompts; default: 4 for "
                         "speculative/compare modes, 0 otherwise")
    ap.add_argument("--speculate-k", type=int, default=4,
                    help="drafted candidate tokens per speculative verify "
                         "tick; the n-gram drafter proposes them from each "
                         "request's own prompt + emitted tokens, and greedy "
                         "acceptance keeps output token-for-token identical "
                         "to plain decode (modes: speculative, compare)")
    ap.add_argument("--load", default="bursty",
                    choices=("poisson", "bursty", "diurnal", "flash"))
    ap.add_argument("--fault-profile", default="none",
                    help="fault injection: a named profile (none/light/heavy) "
                         "or 'nan=0.05,stall=0.02,stallx=8,chunk=0.1,max=20'")
    ap.add_argument("--shed", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="deadline-aware admission control: shed requests "
                         "that cannot finish inside their deadline")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request latency deadline in seconds "
                         "(0 = no deadline)")
    ap.add_argument("--retry-budget", type=int, default=-1,
                    help="max re-prefills per quarantined request before it "
                         "counts as failed (-1 = scheduler default of 4)")
    ap.add_argument("--queue-limit", type=int, default=0,
                    help="shed arrivals once the ready queue holds this many "
                         "requests (0 = unbounded)")
    ap.add_argument("--paged", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="paged KV cache: shared physical pages + page table "
                         "instead of per-slot max_len rectangles")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache rows per physical page (with --paged)")
    ap.add_argument("--share-prefix", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="copy-on-write shared-prefix reuse across requests "
                         "(with --paged; attention families only)")
    ap.add_argument("--quant-weights", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="int8 weight residency: quantize every attention/MLP "
                         "projection to per-output-column int8 at engine init "
                         "(models/quant.py; output is argmax-agreement close "
                         "to f32, not token-identical)")
    ap.add_argument("--quant-kv", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="int8 KV pages: quantize-on-write, dequantize-in-"
                         "gather with per-(page,row,head) f32 scales — ~4x "
                         "less paged-cache device memory (with --paged)")
    ap.add_argument("--page-budget", type=int, default=0,
                    help="physical page count for the paged pool (0 = size "
                         "for contiguous parity); small budgets over-commit "
                         "and exercise preemption (with --paged)")
    ap.add_argument("--preempt-policy", default="none",
                    choices=("none", "tiered", "footprint", "slack"),
                    help="victim-selection policy for preempt-and-restore "
                         "under page pressure (with --paged); none = "
                         "emergency shed-only")
    ap.add_argument("--swap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="allow swap-out restore for preempted slots when "
                         "the cost model prefers it over recompute "
                         "(with --preempt-policy)")
    ap.add_argument("--tier-mix", type=float, default=0.0,
                    help="fraction of requests on the interactive 'latency' "
                         "SLO tier (0 = all batch tier)")
    ap.add_argument("--power-cap", type=float, default=0.0,
                    help="sustained power cap in watts over the whole run "
                         "(0 = uncapped); enforced by the compliance ledger")
    ap.add_argument("--power-faults", default="",
                    help="seeded thermal-throttle fault axis, e.g. "
                         "'therm=0.1,thermf=0.5,thermt=24' (composes with "
                         "--fault-profile)")
    ap.add_argument("--brownout", default="off",
                    choices=("off", "ladder", "uniform"),
                    help="power-deficit response: hysteretic degradation "
                         "ladder, naive uniform throttling, or none")
    ap.add_argument("--energy-budget", type=float, default=0.0,
                    help="hard energy budget in joules per --budget-window "
                         "seconds (0 = none)")
    ap.add_argument("--budget-window", type=float, default=1.0,
                    help="energy-budget window length in seconds")
    ap.add_argument("--policy", default="adaptive",
                    choices=("on_off", "idle_waiting", "slow_down", "adaptive"))
    ap.add_argument("--trace", default="regular",
                    choices=("regular", "irregular", "bursty"),
                    help="gap trace for --mode strategies")
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--period", type=float, default=2.0, help="regular trace period (s)")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    if args.preempt_policy != "none" and not args.paged:
        ap.error("--preempt-policy requires --paged")
    if args.page_budget and not args.paged:
        ap.error("--page-budget requires --paged")
    if args.quant_kv and not args.paged:
        ap.error("--quant-kv requires --paged")
    if args.brownout != "off" and not (args.power_cap > 0 or args.power_faults
                                       or args.energy_budget > 0):
        ap.error("--brownout needs a power constraint: --power-cap, "
                 "--power-faults, or --energy-budget")

    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    cfg = get_reduced_config(args.arch)
    if args.quant_weights:
        cfg = dataclasses.replace(cfg, quant="int8")
    # paged pools need no spec_slack spare rows: verify-window tail blocks
    # are allocated on demand out of the page pool
    slack = (args.speculate_k
             if args.mode in ("speculative", "compare") and not args.paged
             else 0)
    engine = InferenceEngine(cfg, sc=ServeConfig(max_batch=args.batch,
                                                 max_len=args.max_len,
                                                 spec_slack=slack,
                                                 paged=args.paged,
                                                 page_size=args.page_size,
                                                 num_pages=args.page_budget or None,
                                                 share_prefix=args.share_prefix,
                                                 kv_quant="int8" if args.quant_kv
                                                 else None,
                                                 energy_budget_j=(
                                                     args.energy_budget or None),
                                                 budget_window_s=args.budget_window),
                             device=dev)

    if args.mode == "strategies":
        server = WorkloadAwareServer(engine, chips=args.chips)
        t_inf = server.measure_latency(batch=args.batch, new_tokens=args.new_tokens)
        prof = server.profile(t_inf)
        print(f"{args.arch} on {where}: measured batch latency {t_inf * 1e3:.1f} ms, "
              f"reload {prof.t_cfg_s:.2f}s/{prof.e_cfg_j:.0f}J")
        if args.trace == "regular":
            gaps = regular_trace(args.period, t_inf, args.n)
        elif args.trace == "irregular":
            gaps = irregular_trace(prof, n=args.n, seed=args.seed)
        else:
            gaps = bursty_trace(prof, n=args.n, seed=args.seed)
        results = server.compare_strategies(gaps, t_inf=t_inf, batch=args.batch,
                                            new_tokens=args.new_tokens,
                                            execute_every=max(args.n // 4, 1))
        best = max(results, key=lambda k: results[k].items_per_joule)
        for k, v in results.items():
            star = " *" if k == best else ""
            print(f"  {k:14s} items/J={v.items_per_joule:.5f} reloads={v.reloads} "
                  f"missed={v.missed}{star}")
        return 0

    cal = EngineCalibration(engine)
    reqs = _make_stream(args, cfg, cal)
    print(f"{args.arch} on {where}: {args.load} stream, {args.n} requests, "
          f"t_step={cal.step_s() * 1e3:.2f} ms, pool={args.batch}")
    faults = make_profile(args.fault_profile, seed=args.seed)
    if args.power_faults:
        therm = make_profile(args.power_faults, seed=args.seed)
        if therm is not None:
            # graft the thermal axis onto the base profile: one generator,
            # one seed, so the composed run stays deterministic
            faults = therm if faults is None else dataclasses.replace(
                faults, therm_rate=therm.therm_rate,
                therm_frac=therm.therm_frac, therm_ticks=therm.therm_ticks)
    env = None
    if args.power_cap > 0:
        env = PowerEnvelope(caps=(CapWindow(0.0, math.inf, args.power_cap),))
    retry = None
    if args.retry_budget >= 0:
        step = cal.step_s()
        retry = RestartPolicy(max_restarts=args.retry_budget,
                              backoff_s=2 * step, backoff_factor=2.0,
                              max_backoff_s=64 * step)
    robust = dict(shed=args.shed,
                  queue_limit=args.queue_limit or None,
                  faults=faults if faults is not None and faults.enabled else None,
                  retry=retry,
                  power=env,
                  brownout=None if args.brownout == "off" else args.brownout)
    # preempt/swap are paged-only scheduler knobs; keep them out of `robust`
    # so compare mode's contiguous rows stay valid
    preempt_kw = ({"preempt": args.preempt_policy, "swap": args.swap}
                  if args.preempt_policy != "none" else {})
    sched = ContinuousBatchingScheduler(
        engine, policy=args.policy, chips=args.chips, calibration=cal,
        prefill_chunk=args.prefill_chunk if args.mode == "chunked" else None,
        speculate_k=args.speculate_k if args.mode == "speculative" else None,
        **robust, **preempt_kw)
    rep = sched.run(reqs)
    print("  " + rep.summary())
    tau = sched.policy.tau
    if tau is not None:
        print(f"  online tau after run: {tau:.3f} s "
              f"(refits: {getattr(sched.policy, 'refits', 0)})")
    if args.mode == "compare":
        chkd = ContinuousBatchingScheduler(
            engine, policy=args.policy, chips=args.chips, calibration=cal,
            prefill_chunk=args.prefill_chunk, **robust).run(reqs)
        print("  " + chkd.summary())
        spec = ContinuousBatchingScheduler(
            engine, policy=args.policy, chips=args.chips, calibration=cal,
            speculate_k=args.speculate_k, **robust).run(reqs)
        print("  " + spec.summary())
        stat = run_static_batches(engine, reqs, policy=args.policy,
                                  chips=args.chips, calibration=cal,
                                  flush_s=16 * mean_service_s(cal))
        print("  " + stat.summary())
        if args.paged:
            psched, prep = sched, rep  # the main rows already ran paged
        else:
            peng = InferenceEngine(cfg, params=engine.params, sc=ServeConfig(
                max_batch=args.batch, max_len=args.max_len, paged=True,
                page_size=args.page_size, share_prefix=args.share_prefix), device=dev)
            psched = ContinuousBatchingScheduler(
                peng, policy=args.policy, chips=args.chips, calibration=cal,
                **robust, **preempt_kw)
            prep = psched.run(reqs)
            print("  " + prep.summary() + " [paged]")
        pool = psched.pool
        contig_b = cache_bytes(cfg, batch=args.batch,
                               max_len=args.max_len + slack)
        paged_b = paged_cache_bytes(cfg, batch=args.batch,
                                    num_pages=pool.num_pages,
                                    page_size=pool.page,
                                    max_blocks=pool.max_blocks,
                                    kv_quant=pool.kv_quant)
        print(f"  KV-cache HBM at parity sizing: contiguous "
              f"{contig_b / 1e6:.3f} MB vs paged {paged_b / 1e6:.3f} MB "
              f"({pool.num_pages} pages of {pool.page} rows); "
              f"shared page hits={prep.shared_hit_pages}, "
              f"COW copies={prep.cow_copies}")
        print(f"  paged preemption: preempted={prep.preempted} "
              f"(swap={prep.swapped}, recompute={prep.recomputed}), "
              f"evictions={prep.evictions}, "
              f"preempt waste={prep.preempt_wasted_j:.2f} J")
        print(f"  continuous/static items-per-J: "
              f"{rep.items_per_joule / stat.items_per_joule:.2f}x, "
              f"p50 speedup: {stat.p50_s / rep.p50_s:.2f}x, "
              f"chunked/blocking p99 speedup: {rep.p99_s / chkd.p99_s:.2f}x, "
              f"speculative accepted/tick: {spec.accepted_per_tick:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
