"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter
granite-family LM trained for a few hundred steps on the synthetic bigram
stream, with checkpointing, an injected mid-run worker failure (restart +
deterministic replay), and a loss that must fall well below the uniform
entropy.  Trains on ``--device``.

Full run (~100M params, a few hundred steps):
    PYTHONPATH=src python examples/torch/train_lm.py
Quick run (~4M params, 300 steps):
    PYTHONPATH=src python examples/torch/train_lm.py --quick [--device cpu]
"""
import argparse
import math
import os
import shutil
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.training.train_loop import Trainer, TrainerConfig

CRITERION = 0.6  # the final loss must be under this fraction of ln V


def model_100m() -> ArchConfig:
    """Granite-family dense LM, ~100M params (20L × 640d × 1720ff)."""
    return ArchConfig(
        name="granite-100m", family="dense", num_layers=20, d_model=640,
        num_heads=10, num_kv_heads=2, d_ff=1720, vocab_size=8192,
        remat="none", scan_layers=True,
    )


def model_quick() -> ArchConfig:
    return ArchConfig(
        name="granite-4m", family="dense", num_layers=4, d_model=192,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=1024,
        remat="none",
    )


def make_trainer(args) -> tuple[Trainer, int]:
    """The example's Trainer, its failure step set (``args`` as ``main``
    parses them); the checkpoint directory is emptied first."""
    cfg = model_quick() if args.quick else model_100m()
    steps = args.steps or 300
    batch, seq = (16, 128) if args.quick else (16, 256)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                     seed=0, branching=4)
    tc = TrainerConfig(
        num_steps=steps, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=max(steps // 6, 10), log_every=max(steps // 15, 1),
        peak_lr=3e-3, warmup_steps=max(steps // 15, 5),
    )
    trainer = Trainer(cfg, ds, tc, device=args.device)
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params, {steps} steps, "
          f"batch {batch}×{seq} tokens, on {trainer.device}")
    fail_at = args.inject_failure if args.inject_failure >= 0 else steps // 2
    trainer._failure_at = fail_at
    print(f"(worker failure injected at step {fail_at}; expect restore+replay)")
    return trainer, fail_at


def report(trainer: Trainer, stats: dict) -> bool:
    """Print the run's table and verdict; True if the final loss is under
    ``CRITERION`` · ln V."""
    floor = math.log(4)  # nats: the bigram chain has 4 successors a token
    uni = math.log(trainer.cfg.vocab_size)
    print(f"\nrestarts: {stats['restarts']}")
    print(f"{'step':>6s} {'loss':>8s} {'grad':>8s} {'lr':>9s} {'s/step':>7s}")
    for m in stats["metrics"]:
        print(f"{m['step']:6d} {m['loss']:8.4f} {m['grad_norm']:8.2f} "
              f"{m['lr']:9.2e} {m['time_s']:7.2f}")
    final = stats["metrics"][-1]["loss"]
    print(f"\nuniform loss = ln V = {uni:.2f}; bigram floor = ln 4 = {floor:.2f}; "
          f"final = {final:.3f}")
    ok = final < CRITERION * uni
    print("loss fell well below the uniform entropy ✓" if ok
          else "WARNING: loss did not fall enough")
    return ok


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="step at which to inject a WorkerFailure (-1 = steps//2)")
    ap.add_argument("--device", default=None, help="'cuda' (default; fails without a card) "
                                                   "or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    trainer, _ = make_trainer(parse(argv))
    return 0 if report(trainer, trainer.run()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
