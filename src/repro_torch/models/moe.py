"""Mixture-of-Experts, on one device.

The JAX package has three execution paths, chosen by the mesh:

  dense  — every expert on every token, weighted by top-k gates. Exact, no
           mesh needed; what the JAX package runs on one device.
  gather — all_gather the (few) tokens over the expert-sharding axes.
  a2a    — capacity-bucketed scatter into per-expert slots, all_to_all over
           the expert-sharding axes, local expert GEMMs, reverse all_to_all.

The port runs on one device, so :func:`moe_apply` takes the dense path, as
the JAX package does with no mesh; given a mesh it raises (the sharded
bodies wait for ROADMAP Queue A item 14).  The per-device pieces of the a2a
path that are plain tensor functions (:func:`_positions_in_expert`,
:func:`_dispatch_local`, :func:`_combine_local`) are here, held to the JAX
package by the tests.  Every shape is static (capacity-overflow tokens go to
a scratch row, not through a data-dependent index), so a CUDA graph can
capture each of them.

Expert weights are stacked (E_pad, d, f); E is padded at config time and the
padding experts are masked in the router.  The three expert einsums go
through ``qeinsum`` with the expert axis as its batch label: with int8
weights, each is ONE launch of ``int8_matmul`` over the expert axis, and the
dense path's token block, shared by every expert, is quantized once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef
from repro_torch.models.quant import qeinsum


def _epad(cfg: ArchConfig) -> int:
    m = cfg.moe
    return m.padded_experts or m.num_experts


def moe_defs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d, f, ep = cfg.d_model, m.expert_d_ff, _epad(cfg)
    defs = {
        "router": ParamDef((d, ep), (None, None), dtype=torch.float32),
        "wg": ParamDef((ep, d, f), ("experts", "embed", None)),
        "wu": ParamDef((ep, d, f), ("experts", "embed", None)),
        "wd": ParamDef((ep, f, d), ("experts", None, "embed")),
    }
    if m.num_shared:
        shared_f = m.shared_d_ff * m.num_shared
        defs["shared"] = {
            "wg": ParamDef((d, shared_f), ("embed", "mlp")),
            "wu": ParamDef((d, shared_f), ("embed", "mlp")),
            "wd": ParamDef((shared_f, d), ("mlp", "embed")),
        }
    return defs


def _router(params, x2d, cfg: ArchConfig):
    """x2d: (T, D) → top-k weights (T, k), ids (T, k), probs (T, E_pad) f32.

    Top-k is a stable descending sort: among equal probabilities the lower
    expert index comes first, as ``jax.lax.top_k`` takes it (``torch.topk``
    promises no order on ties)."""
    m = cfg.moe
    logits = x2d.to(torch.float32) @ params["router"].to(torch.float32)
    ep = logits.shape[-1]
    if ep > m.num_experts:  # mask config-time padding experts
        real = torch.arange(ep, device=logits.device) < m.num_experts
        logits = torch.where(real[None, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :m.top_k], ids[:, :m.top_k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)  # renormalize top-k
    return w, ids, probs


def _expert_ffn(wg, wu, wd, x, cfg: ArchConfig):
    """Batched expert GEMMs. x: (E, C, D) → (E, C, D)."""
    from repro_torch.models.activations import get_activation

    act = get_activation(cfg.activation, cfg.activation_impl)
    g = qeinsum("ecd,edf->ecf", x, wg)
    u = qeinsum("ecd,edf->ecf", x, wu)
    return qeinsum("ecf,efd->ecd", act(g) * u, wd)


def _shared_ffn(shared, x, cfg: ArchConfig):
    """The shared-expert MLP."""
    from repro_torch.models.activations import get_activation

    act = get_activation(cfg.activation, cfg.activation_impl)
    g = qeinsum("bsd,df->bsf", x, shared["wg"])
    u = qeinsum("bsd,df->bsf", x, shared["wu"])
    return qeinsum("bsf,fd->bsd", act(g) * u, shared["wd"])


def _aux_loss(probs, ids, cfg: ArchConfig):
    """Switch-style load-balance loss (computed over local tokens)."""
    e = probs.shape[-1]
    counts = F.one_hot(ids, e).to(torch.float32).sum(dim=tuple(range(ids.dim())))
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    mean_prob = probs.reshape(-1, e).mean(dim=0)
    return cfg.moe.num_experts * torch.sum(frac * mean_prob)


# ---------------------------------------------------------------------------
# dense path
# ---------------------------------------------------------------------------
def _moe_dense(params, x, cfg: ArchConfig):
    """Every padded expert on every token (the block is expanded over the
    expert axis, not copied), combined by the top-k gates cast to
    ``x.dtype``, as the JAX package does."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    w, ids, probs = _router(params, xf, cfg)
    ep = _epad(cfg)
    h = _expert_ffn(params["wg"], params["wu"], params["wd"], xf[None].expand(ep, b * s, d),
                    cfg)  # (E, T, D)
    gates = torch.zeros((b * s, ep), dtype=x.dtype, device=x.device)
    gates.scatter_(1, ids, w.to(x.dtype))
    y = torch.einsum("te,etd->td", gates, h)
    return y.reshape(b, s, d), _aux_loss(probs, ids, cfg)


# ---------------------------------------------------------------------------
# per-device pieces of the a2a path
# ---------------------------------------------------------------------------
def _positions_in_expert(ids_flat, ep: int):
    """Slot index of each assignment within its expert's capacity bucket."""
    oh = F.one_hot(ids_flat, ep).to(torch.int32)  # (A, E)
    pos = torch.cumsum(oh, dim=0) * oh  # 1-based where selected
    return pos.sum(dim=1) - 1  # (A,) 0-based


def _dispatch_local(params, xt, cfg: ArchConfig, capacity: int):
    """Route local tokens xt (t, D) into a capacity buffer (E_pad, C, D).
    Assignments past an expert's capacity are dropped (they land in a
    scratch row that is cut off), as a scatter with ``mode="drop"``."""
    m = cfg.moe
    ep = _epad(cfg)
    t, d = xt.shape
    w, ids, probs = _router(params, xt, cfg)
    ids_flat = ids.reshape(-1)  # (t·k,)
    pos = _positions_in_expert(ids_flat, ep)
    tok_idx = torch.arange(t, device=xt.device).repeat_interleave(m.top_k)
    slot = torch.where(pos < capacity, ids_flat * capacity + pos,
                       torch.full_like(pos, ep * capacity))
    buf = torch.zeros((ep * capacity + 1, d), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt[tok_idx]
    return buf[:-1].reshape(ep, capacity, d), (w, ids_flat, pos, tok_idx), (probs, ids)


def _combine_local(buf_out, route, t: int, d: int, dtype):
    """Gather each assignment's expert output (zero where it was dropped,
    as a gather with ``mode="fill"``), weight it in f32 and sum per token."""
    w, ids_flat, pos, tok_idx = route
    kept = pos < buf_out.shape[1]
    y_k = buf_out[ids_flat, torch.clamp(pos, max=buf_out.shape[1] - 1)]  # (t·k, D)
    y_k = torch.where(kept[:, None], y_k, torch.zeros_like(y_k))
    contrib = y_k.to(torch.float32) * w.reshape(-1)[:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=buf_out.device)
    return y.index_add_(0, tok_idx, contrib).to(dtype)


def moe_apply(params, x, cfg: ArchConfig, mesh=None):
    """Returns (y, aux_loss): the dense path, as the JAX package runs it
    with no mesh.  The sharded paths (gather, a2a) need a mesh and are not
    ported."""
    if mesh is not None:
        raise NotImplementedError("the sharded MoE paths (gather, a2a) are not ported yet "
                                  "(ROADMAP Queue A item 14)")
    y, aux = _moe_dense(params, x, cfg)
    if cfg.moe.num_shared:
        y = y + _shared_ffn(params["shared"], x, cfg)
    return y, aux
