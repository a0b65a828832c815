"""Workload-aware serving example on the PyTorch/CUDA port: a real
(reduced-config) model served by the continuous-batching scheduler —
requests of different prompt lengths and token budgets admitted into free
slots mid-decode, with the online streaming-τ policy duty-cycling the card
between queue drains — then the same stream through the static-batch
baseline, and the classic offline strategy comparison for reference.

The engine serves int8 weights, as every serving path of the port does:
its projections run through the hand-written int8 matmul kernel (K5) on the
card.  The scheduler's costs are measured on ``--device`` and its energy
ledger uses ``H100Chip``'s constants.

Run:  PYTHONPATH=src python examples/torch/serve_workload.py [--arch granite-3-8b] [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_reduced_config, list_archs
from repro_torch.core.workload import break_even_tau, bursty_trace, regular_trace
from repro_torch.serving.engine import InferenceEngine, ServeConfig, WorkloadAwareServer
from repro_torch.serving.load import bursty_stream_for_service, mean_service_s
from repro_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    EngineCalibration,
    run_static_batches,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--device", default=None, help="'cuda' (default; fails without a card) "
                                                   "or 'cpu'")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_reduced_config(args.arch), quant="int8")
    engine = InferenceEngine(cfg, sc=ServeConfig(max_batch=4, max_len=64), device=args.device)
    print(f"engine: {args.arch} (reduced: {cfg.num_layers}L × {cfg.d_model}d, int8 weights) "
          f"on {engine.device}, greedy decode, 4-slot pool")
    demo = engine.generate(np.arange(24, dtype=np.int32).reshape(4, 6) % cfg.vocab_size, 6)
    print(f"sample continuations: {demo.tolist()}")

    # -- continuous batching vs static batches on one bursty request stream --
    cal = EngineCalibration(engine)
    t_step = cal.step_s()
    service = mean_service_s(cal)
    reqs = bursty_stream_for_service(cal, args.n, vocab_size=cfg.vocab_size,
                                     seed=0, new_tokens=(4, 16))
    sched = ContinuousBatchingScheduler(engine, policy="adaptive", calibration=cal)
    cont = sched.run(reqs)
    stat = run_static_batches(engine, reqs, policy="adaptive", calibration=cal,
                              flush_s=16 * service)
    print(f"\nbursty stream, {args.n} requests (t_step {t_step * 1e3:.2f} ms):")
    print("  " + cont.summary())
    print("  " + stat.summary())
    print(f"  -> continuous batching: {cont.items_per_joule / stat.items_per_joule:.2f}x "
          f"items/J, {stat.p50_s / cont.p50_s:.2f}x lower p50 latency")

    # -- classic offline strategy comparison (duty-cycle theory check) -------
    server = WorkloadAwareServer(engine, chips=1)
    t_inf = server.measure_latency(batch=4, new_tokens=4)
    prof = server.profile(t_inf)
    tau = break_even_tau(prof)
    print(f"\nmeasured batch latency {t_inf * 1e3:.0f} ms; reload {prof.t_cfg_s:.2f} s; "
          f"break-even τ = {tau:.2f} s")
    regimes = {
        "fast-regular (gap ≈ 0.1·τ)": regular_trace(0.1 * tau + t_inf, t_inf, args.n),
        "slow-regular (gap ≈ 10·τ)": regular_trace(10 * tau + t_inf, t_inf, args.n),
        "bursty": bursty_trace(prof, n=args.n, seed=0),
    }
    for name, gaps in regimes.items():
        results = server.compare_strategies(gaps, t_inf=t_inf, batch=4, new_tokens=4)
        best = max(results, key=lambda k: results[k].items_per_joule)
        print(f"\n{name}:")
        for k, v in results.items():
            mark = "  <- best" if k == best else ""
            print(f"  {k:14s} {v.items_per_joule:10.4f} items/J  "
                  f"reloads={v.reloads:4d}{mark}")
    print("\nexpected: idle/slow-down win fast-regular; on-off/adaptive win "
          "slow-regular; adaptive wins bursty; continuous batching beats "
          "static on items/J and p50")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
