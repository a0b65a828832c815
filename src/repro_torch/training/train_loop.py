"""Training loop: the train step and the Trainer, with fault tolerance.

``make_train_step`` builds train_step(params, opt_state, batch, step) →
(params, opt_state, metrics), the reference's (``repro.training.train_loop``)
on one device: microbatch gradient accumulation (``accum``, a loop over
batch slices where the reference scans), AdamW / Adafactor by
``cfg.optimizer``, the cosine schedule and the global-norm clip.  The params
and the optimizer state are updated in place (the reference donates them)
and returned.  The reference's mesh argument and its sharding helpers
(``state_shardings``, ``abstract_state``) wait for multi-device training,
ROADMAP Queue A item 14.

``Trainer`` drives it: data → step → metrics / checkpoints / fault handling
(checkpoint every N steps on a thread, straggler detection, restart on a
``WorkerFailure`` with the data replayed from the restored step).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import init_model, param_defs, train_loss
from repro_torch.models.params import tree_flatten, tree_unflatten
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault import StragglerDetector, WorkerFailure, run_with_restarts
from repro_torch.training.optimizer import (
    Schedule,
    clip_by_global_norm,
    init_opt_state,
    opt_update,
)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------
def _grads_of(params, batch, cfg: ArchConfig):
    """(loss, metrics, grads) of ``train_loss``; the grads in the params'
    dtypes, zeros for a leaf the loss does not reach (as JAX gives)."""
    leaves = tree_flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = train_loss(tree_unflatten(params, xs), batch, cfg)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def loss_and_grads(cfg: ArchConfig, params, batch, accum: int = 1):
    """(loss, metrics, grads) over ``batch`` in ``accum`` microbatches: the
    loss and the grads are the microbatches' means, summed into f32 zeros
    (each microbatch's grads divided by ``accum`` in their own dtype first,
    as the reference does; ``.grad`` accumulation would sum bf16 leaves in
    bf16); the metrics are the last microbatch's."""
    if accum == 1:
        return _grads_of(params, batch, cfg)
    mb = batch["tokens"].shape[0] // accum
    dev = batch["tokens"].device
    count = torch.full((), accum, dtype=torch.float32, device=dev)  # a true division on the card
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_flatten(params)]
    for i in range(accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l, metrics, g = _grads_of(params, micro, cfg)
        loss = loss + l / count
        for acc, gi in zip(grads, tree_flatten(g)):
            acc.add_(gi / count)
        del g
    return loss, metrics, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, schedule: Schedule | None = None, *, accum: int = 1):
    """Returns train_step(params, opt_state, batch, step), updating params
    and opt_state in place."""
    schedule = schedule or Schedule()

    def train_step(params, opt_state, batch, step):
        _, metrics, grads = loss_and_grads(cfg, params, batch, accum)
        grads, gnorm = clip_by_global_norm(grads)
        lr = schedule(step)
        params, opt_state = opt_update(cfg.optimizer, params, grads, opt_state, lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    accum: int = 1
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    peak_lr: float = 3e-3
    warmup_steps: int = 20
    seed: int = 0


class Trainer:
    """End to end: data → step → metrics/checkpoints/fault handling,
    on ``device`` (``None`` means the card).  The parameters are drawn from
    a generator on that device seeded with ``tc.seed``."""

    def __init__(self, cfg: ArchConfig, ds: SyntheticLM, tc: TrainerConfig, device=None):
        self.cfg, self.ds, self.tc = cfg, ds, tc
        self.device = resolve_device(device)
        self.schedule = Schedule(
            peak_lr=tc.peak_lr, warmup_steps=tc.warmup_steps, total_steps=tc.num_steps
        )
        self.ckpt = CheckpointManager(tc.checkpoint_dir, keep=tc.keep)
        self.detector = StragglerDetector()
        self.metrics_log: list[dict] = []
        self.step_fn = make_train_step(cfg, self.schedule, accum=tc.accum)
        self.params, self.opt_state = self._init_state()
        self._failure_at: int | None = None  # test hook: inject WorkerFailure

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_model(self.cfg, gen, self.device)
        return params, init_opt_state(self.cfg.optimizer, param_defs(self.cfg), params)

    # -- one step -------------------------------------------------------------
    def _do_step(self, step: int):
        if self._failure_at is not None and step == self._failure_at:
            self._failure_at = None  # fail once
            raise WorkerFailure(f"injected failure at step {step}")
        batch = make_batch(self.cfg, self.ds, step, device=self.device)
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch, step)
        if self.device.type == "cuda":  # the step's time is the card's, not its enqueue
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if self.detector.observe(dt):
            self.detector.reset()  # mitigation: snapshot now, keep going
            self.ckpt.save(step, self._state(), metadata={"straggler": True})
        if step % self.tc.log_every == 0 or step == self.tc.num_steps - 1:
            row = {k: float(v) for k, v in metrics.items()} | {"step": step, "time_s": dt}
            self.metrics_log.append(row)
        if step > 0 and step % self.tc.checkpoint_every == 0:
            self.ckpt.save(step, self._state(), metadata={"loss": float(metrics["loss"])})

    def _state(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def _restore(self) -> int:
        """Back to the latest committed checkpoint, in place (every tensor
        keeps its storage), or to the seeded init when there is none.
        Waits for a save in flight first, which the reference does not:
        its restore then finds the previous checkpoint, or none."""
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            # no checkpoint yet: restart from scratch (deterministic init)
            self.params = self.opt_state = None  # one state on the device at a time
            self.params, self.opt_state = self._init_state()
            return 0
        step, state, _ = self.ckpt.restore(like=self._state(), device="cpu")
        for dst, src in zip(tree_flatten(self._state()), tree_flatten(state)):
            dst.copy_(src)
        return step + 1  # resume after the checkpointed step

    # -- loop -------------------------------------------------------------------
    def run(self, start_step: int = 0) -> dict:
        stats = run_with_restarts(
            self._do_step,
            start_step=start_step,
            num_steps=self.tc.num_steps - start_step,
            restore_fn=self._restore,
            sleep=lambda s: None,
        )
        self.ckpt.save(self.tc.num_steps - 1, self._state(), blocking=True,
                       metadata={"final": True})
        return stats | {"metrics": self.metrics_log}
