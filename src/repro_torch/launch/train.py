"""Launcher.

Only the ``--paper-lstm`` mode of the reference's launcher is ported: it
plans the paper's own LSTM workload on the CUDA kernel mapping.  It reports
the block-size tuner's key, winner and predicted time a call, and the launch
geometry of the sequence kernel (``repro_torch.kernels.lstm_seq``: its path,
batch tile, cluster size and count, projection chunk and shared memory),
checks the kernel against the plain PyTorch per-step path, and, on the card,
times it against the per-step cell kernel.  Despite the module's name this
mode runs inference only.

The ``--arch`` modes (training plans and runs) are not ported yet; asking for
one is an error.

Examples:
  python -m repro_torch.launch.train --paper-lstm --batch 64
  python -m repro_torch.launch.train --paper-lstm --batch 4 --seq 6 --device cpu
"""
from __future__ import annotations

import argparse
import math

import torch


def plan_paper_lstm(batch: int, seq: int = 0, device=None) -> dict:
    """Kernel-level plan for the paper's flagship LSTM workload.

    Runs on the card (``device=None``) unless the caller names the CPU, where
    the kernels' plain versions stand in and nothing is timed.  Returns what
    it printed, as a dict."""
    from repro_torch.core.fpga import paper_workload
    from repro_torch.kernels.autotune import autotune, cache_key, chip_with_slots, predict_time_s
    from repro_torch.kernels.lstm_seq import cluster_slots, plan_launch
    from repro_torch.kernels.runtime import backend_key, resolve_device
    from repro_torch.models.lstm import lstm_apply, lstm_defs
    from repro_torch.models.params import init_params, tree_map

    dev = resolve_device(device)
    lw = paper_workload()
    seq = seq or lw.seq
    slots = cluster_slots(dev)
    plan = plan_launch("auto", batch, seq, lw.d_in, lw.hidden, slots=slots,
                       backend=backend_key(dev))
    problem = {"batch": batch, "seq": seq, "d_in": lw.d_in, "hidden": lw.hidden}
    chip = chip_with_slots(slots)
    key = cache_key("lstm_seq", problem, "float32", backend_key(dev), chip)
    cfg = autotune("lstm_seq", problem, dtype="float32", backend=backend_key(dev), chip=chip)
    predicted_us = predict_time_s("lstm_seq", problem, cfg, chip=chip) * 1e6
    print(f"paper LSTM workload: batch={batch} seq={seq} d_in={lw.d_in} "
          f"hidden={lw.hidden} backend={backend_key(dev)}")
    print(f"autotune[{key}] → {cfg} (predicted {predicted_us:.1f} µs/call)")
    weights = {"block": "resident in one block's shared memory",
               "cluster": "u's slices resident across each cluster's blocks",
               "l2": "re-read from L2 each step"}[plan.path]
    print(f"launch plan: path={plan.path} block_b={plan.block_b} cluster={plan.cluster} "
          f"clusters={plan.clusters} chunk={plan.chunk} blocks={plan.clusters * plan.cluster} "
          f"resident={plan.resident}: weights {weights} "
          f"({plan.smem_bytes} bytes of shared memory per block)")

    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.to(torch.float32),
                      init_params(lstm_defs(lw.d_in, lw.hidden), gen, dev))
    x = torch.randn((batch, seq, lw.d_in), generator=gen, dtype=torch.float32).to(dev)
    got = lstm_apply(params, x, fused="pallas_seq")
    want = lstm_apply(params, x, fused=True)
    err = float((got - want).abs().max())
    print(f"sequence kernel vs plain PyTorch reference: max |Δ| = {err:.2e}")
    if not (math.isfinite(err) and err < 1e-4):
        raise RuntimeError(f"sequence kernel disagrees with the reference: max |Δ| = {err}")
    result = {"batch": batch, "seq": seq, "backend": backend_key(dev), "autotune_key": key,
              "autotune": cfg, "predicted_us": predicted_us, "path": plan.path,
              "block_b": plan.block_b, "resident": plan.resident, "cluster": plan.cluster,
              "clusters": plan.clusters, "chunk": plan.chunk, "smem_bytes": plan.smem_bytes,
              "max_abs_err": err}

    if dev.type == "cuda":
        from repro_torch.kernels.bench import compare_lstm_paths

        seq_us, step_us = compare_lstm_paths(batch, seq, lw.d_in, lw.hidden, n=15, device=dev)
        print(f"median per-call on {torch.cuda.get_device_name(dev)}: sequence kernel "
              f"{seq_us:.0f} µs vs per-step kernel {step_us:.0f} µs ({step_us / seq_us:.2f}x)")
        result.update(seq_us=seq_us, step_us=step_us)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", help="not ported yet")
    ap.add_argument("--paper-lstm", action="store_true",
                    help="plan the paper LSTM workload on the CUDA kernel mapping")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the paper workload's 28)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    if args.arch is not None:
        ap.error("--arch modes are not ported to repro_torch yet; use repro.launch.train")
    if not args.paper_lstm:
        ap.error("--paper-lstm is the only mode ported so far")
    plan_paper_lstm(args.batch, args.seq or 0, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
