"""Training launcher.

Three modes:

  --arch ARCH [--shape SHAPE] [--multi-pod]
                          plan only: print the parallelism plan, parameter
                          and optimizer footprint per device, and the
                          analytical roofline of the chosen (arch × shape ×
                          mesh) on ``core.energy.H100Chip``, what to check
                          before spending GPU-hours.  The
                          mesh is the reference's: dp 16 (32 with
                          ``--multi-pod``) × tp 16, FSDP above 10 B params.
  --arch ARCH --execute   really train (a reduced config with ``--reduced``,
                          or the full one) with the fault-tolerant
                          ``training.train_loop.Trainer``: synthetic-bigram
                          data, AdamW/Adafactor, async checkpoints,
                          straggler detection, restart-with-replay.  Runs on
                          the card unless ``--device cpu`` asks for the CPU.
  --paper-lstm            plans the paper's own LSTM workload on the CUDA
                          kernel mapping.  It reports the block-size tuner's
                          key, winner and predicted time a call, and the
                          launch geometry of the sequence kernel
                          (``repro_torch.kernels.lstm_seq``: its path, batch
                          tile, cluster size and count, projection chunk and
                          shared memory), checks the kernel against the
                          plain PyTorch per-step path, and, on the card,
                          times it against the per-step cell kernel.  This
                          mode runs inference only.

Examples:
  python -m repro_torch.launch.train --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.train --arch granite-3-8b --reduced --execute --steps 20
  python -m repro_torch.launch.train --arch granite-3-8b --reduced --execute --steps 20 --device cpu
  python -m repro_torch.launch.train --paper-lstm --batch 64
  python -m repro_torch.launch.train --paper-lstm --batch 4 --seq 6 --device cpu
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from repro_torch.core.energy import DEFAULT_CHIP, H100Chip


def plan(arch: str, shape_id: str, multi_pod: bool, chip: H100Chip = DEFAULT_CHIP) -> None:
    """Print the reference's five plan lines, estimated on ``chip``."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import MeshPlan, bytes_per_device_estimate, estimate_step

    cfg = get_config(arch)
    dp = 32 if multi_pod else 16
    p = MeshPlan(dp=dp, tp=16, fsdp=cfg.param_count() > 10e9)
    r = estimate_step(cfg, shape_id, p, chip=chip)
    print(f"arch={arch} shape={shape_id} chips={p.chips} (dp={p.dp} tp={p.tp} fsdp={p.fsdp})")
    print(f"params={cfg.param_count() / 1e9:.2f}B active={cfg.active_param_count() / 1e9:.2f}B "
          f"optimizer={cfg.optimizer}")
    print(f"resident/device ≈ {bytes_per_device_estimate(cfg, shape_id, p) / 1e9:.2f} GB")
    s = r.summary()
    print(f"roofline: compute={s['compute_s']:.3f}s memory={s['memory_s']:.3f}s "
          f"collective={s['collective_s']:.3f}s → T={s['t_step_s']:.3f}s "
          f"bottleneck={s['bottleneck']} mfu={s['mfu']:.3f}")
    print(f"energy/step ≈ {s['energy_j'] / 1e3:.1f} kJ → {s['gflops_per_j']:.0f} GFLOPs/J")


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


def train(arch: str, *, reduced: bool, steps: int, batch: int, seq: int, accum: int,
          ckpt_dir: str, device=None) -> dict:
    """Train ``arch`` with the ``Trainer`` for ``steps`` steps on ``device``
    (``None`` means the card); returns the Trainer's run statistics."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.training.train_loop import Trainer, TrainerConfig

    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    tc = TrainerConfig(num_steps=steps, accum=accum, checkpoint_dir=ckpt_dir,
                       log_every=max(steps // 10, 1))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"training {cfg.name} on {where}: {steps} steps of {batch} x {seq} tokens, "
          f"accum {accum}, optimizer {cfg.optimizer}")
    stats = Trainer(cfg, ds, tc, device=dev).run()
    first, last = stats["metrics"][0], stats["metrics"][-1]
    print(f"steps={stats['final_step']} restarts={stats['restarts']} "
          f"loss {first['loss']:.3f} → {last['loss']:.3f}")
    return stats


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES, list_archs

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--execute", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--paper-lstm", action="store_true",
                    help="plan the paper LSTM workload on the CUDA kernel mapping")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: 128, or the paper workload's 28 "
                         "under --paper-lstm)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    if args.paper_lstm:
        plan_paper_lstm(args.batch, args.seq or 0, device=args.device)
        return 0
    if args.arch is None:
        ap.error("--arch is required unless --paper-lstm is given")
    if not args.execute:
        plan(args.arch, args.shape, args.multi_pod)
        return 0
    train(args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
          seq=args.seq or 128, accum=args.accum, ckpt_dir=args.ckpt_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
