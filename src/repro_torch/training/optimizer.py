"""Optimizers: AdamW and Adafactor, with ParamDef-declared state trees.

State is declared the way model params are (ParamDef trees), as in the
reference (``repro.training.optimizer``).  All state is float32 whatever the
param dtype (bf16 Adam moments diverge); AdamW keeps f32 master weights.
deepseek-v3-671b pins ``optimizer="adafactor"`` (factored second moments:
O(rows+cols) instead of O(rows·cols)).

Plain tensor code in the reference's order of operations, not
``torch.optim`` (whose AdamW keeps no f32 masters and places its decay and
eps otherwise).  The updates write the params and the state tensors in
place, where the reference returns new arrays and donates the old ones;
the step's scalars (learning rate, bias corrections, Adafactor's beta2) are
0-d f32 tensors, as the reference computes them in f32.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import ParamDef, init_params, tree_flatten, tree_map

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8
FACTOR_B2_POW = 0.8  # adafactor: beta2_t = 1 - t^-0.8
FACTOR_EPS = 1e-30
CLIP_NORM = 1.0


# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Schedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_ratio: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        """The learning rate at ``step``: a 0-d f32 tensor on the CPU (an
        operand the card takes as a scalar), computed in f32 there: the
        card's division by a Python number multiplies by its reciprocal."""
        step = torch.as_tensor(step).to("cpu", torch.float32)
        warm = self.peak_lr * torch.clamp_max(step / max(self.warmup_steps, 1), 1.0)
        t = torch.clamp(
            (step - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = self.min_ratio + (1 - self.min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < self.warmup_steps, warm, self.peak_lr * cos)


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    leaves = tree_flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves))


def clip_by_global_norm(tree, max_norm: float = CLIP_NORM):
    """(the tree scaled to a global norm of at most ``max_norm``, its norm)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_state_defs(defs) -> dict:
    f32 = lambda d: dataclasses.replace(d, dtype=torch.float32, init="zeros")  # noqa: E731
    return {
        "m": tree_map(f32, defs),
        "v": tree_map(f32, defs),
        # f32 MASTER weights: Adam's normalized step (~lr) rounds to zero
        # against bf16 ULP once weights reach O(0.1).  Initialized FROM the
        # params (init_opt_state).
        "master": tree_map(f32, defs),
        "step": ParamDef((), (), init="zeros", dtype=torch.int32),
    }


@torch.no_grad()
def adamw_update(params, grads, state, lr, *, weight_decay: float = 0.1):
    """One AdamW step, in place on ``params`` and ``state``; returns both."""
    t = state["step"] + 1
    tf = t.to(torch.float32)
    bc1 = 1.0 - ADAM_B1 ** tf
    bc2 = 1.0 - ADAM_B2 ** tf
    trees = (params, grads, state["m"], state["v"], state["master"])
    for p, g, m, v, mw in zip(*map(tree_flatten, trees)):
        gf = g.to(torch.float32)
        m.mul_(ADAM_B1).add_((1 - ADAM_B1) * gf)
        v.mul_(ADAM_B2).add_((1 - ADAM_B2) * gf * gf)
        # (m / bc1) / (sqrt(v / bc2) + eps), in place on the temporaries
        step = (m / bc1).div_((v / bc2).sqrt_().add_(ADAM_EPS))
        step.add_(weight_decay * mw if p.ndim >= 2 else 0.0)
        mw.sub_(step.mul_(lr))
        p.copy_(mw)
    state["step"].copy_(t)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored over the trailing two dims
# ---------------------------------------------------------------------------
def factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_state_defs(defs) -> dict:
    def row(d: ParamDef):
        if factored(d.shape):
            return ParamDef(d.shape[:-1], d.logical[:-1], init="zeros", dtype=torch.float32)
        return ParamDef(d.shape, d.logical, init="zeros", dtype=torch.float32)

    def col(d: ParamDef):
        if factored(d.shape):
            return ParamDef(d.shape[:-2] + d.shape[-1:], d.logical[:-2] + d.logical[-1:],
                            init="zeros", dtype=torch.float32)
        return ParamDef((1,), (None,), init="zeros", dtype=torch.float32)

    return {
        "vr": tree_map(row, defs),
        "vc": tree_map(col, defs),
        "step": ParamDef((), (), init="zeros", dtype=torch.int32),
    }


def adafactor_beta2(t: torch.Tensor) -> torch.Tensor:
    """The second-moment decay at step ``t`` (counted from 1)."""
    return 1.0 - torch.pow(t.to(torch.float32), -FACTOR_B2_POW)


@torch.no_grad()
def adafactor_leaf(p, g, vr, vc, beta2, lr, *, weight_decay: float = 0.0,
                   clip_threshold: float = 1.0, total_sq=None, numel: int = 0) -> None:
    """One leaf's Adafactor step, in place on ``p``, ``vr`` and ``vc``.  A
    stacked leaf (layers first) is factored over its trailing two dims and
    RMS-clipped as a whole, as in the reference.  The f32 work runs in
    place on one f32 copy of the gradient: at most two f32 tensors of the
    leaf's size exist at a time (an embedding table's update is the step's
    largest transient).  On a block of a leaf split along its leading dims
    (the factored dims whole), ``total_sq`` sums the blocks' sums of
    squares of the update over the ranks and ``numel`` is the whole leaf's
    size: the clip's RMS is the whole leaf's."""
    gf = g.to(torch.float32, copy=True)
    g2 = torch.square(gf).add_(FACTOR_EPS)
    if factored(p.shape):
        vr.copy_(beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1))
        vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
        del g2
        r_factor = torch.rsqrt(
            vr / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), FACTOR_EPS))
        c_factor = torch.rsqrt(vc)
        update = gf.mul_(r_factor[..., None]).mul_(c_factor[..., None, :])
    else:
        vr.copy_(beta2 * vr + (1 - beta2) * g2)
        del g2
        update = gf.mul_(torch.rsqrt(vr))
    # RMS clip (adafactor's update clipping)
    if total_sq is None:
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
    else:
        rms = torch.sqrt(total_sq(torch.sum(torch.square(update))) / numel + 1e-30)
    update.div_(torch.clamp_min(rms / clip_threshold, 1.0))
    if weight_decay and p.ndim >= 2:
        update.add_(weight_decay * p.to(torch.float32))
    p.copy_(p.to(torch.float32).sub_(update.mul_(lr)))


def adafactor_update(params, grads, state, lr, *, weight_decay: float = 0.0,
                     clip_threshold: float = 1.0):
    """One Adafactor step, in place on ``params`` and ``state``, leaf by
    leaf (``adafactor_leaf``); returns both."""
    t = state["step"] + 1
    beta2 = adafactor_beta2(t)
    for p, g, vr, vc in zip(*map(tree_flatten, (params, grads, state["vr"], state["vc"]))):
        adafactor_leaf(p, g, vr, vc, beta2, lr, weight_decay=weight_decay,
                       clip_threshold=clip_threshold)
    state["step"].copy_(t)
    return params, state


# ---------------------------------------------------------------------------
# Uniform interface
# ---------------------------------------------------------------------------
def opt_state_defs(name: str, defs) -> dict:
    if name == "adamw":
        return adamw_state_defs(defs)
    if name == "adafactor":
        # no master copy: factored states exist to stay sub-weight-sized
        return adafactor_state_defs(defs)
    raise ValueError(name)


def init_opt_state(name: str, defs, params):
    """Materialize optimizer state on the params' device; AdamW masters
    start as f32 copies of the params.  A copy even of an f32 param
    (``.to(float32)`` would return the param itself): the updates write the
    masters in place."""
    return opt_state_from_defs(opt_state_defs(name, defs), params)


def opt_state_from_defs(state_defs: dict, params):
    """``init_opt_state`` from the state's ParamDefs (``opt_state_defs``'s,
    or a rank's block shapes of them, with ``params`` its blocks)."""
    dev = tree_flatten(params)[0].device
    state_defs = dict(state_defs)
    masters = state_defs.pop("master", None)
    state = init_params(state_defs, torch.Generator(), dev)  # zeros: nothing is drawn
    if masters is not None:
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def opt_update(name: str, params, grads, state, lr):
    if name == "adamw":
        return adamw_update(params, grads, state, lr)
    if name == "adafactor":
        return adafactor_update(params, grads, state, lr)
    raise ValueError(name)
