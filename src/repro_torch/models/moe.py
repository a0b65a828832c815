"""Mixture-of-Experts with expert parallelism.

Three execution paths, chosen by the active mesh (``sharding.rules.
activate_mesh``), as in the JAX package:

  dense  — every expert on every token, weighted by top-k gates. Exact, no
           mesh needed (or a mesh of one rank); the numerical oracle.
  gather — all_gather the (few) tokens over the expert-sharding axes that
           shard tokens, each rank computes its local expert shard for all
           of them, then sums over the expert axes. No capacity drops; right
           for decode steps.
  a2a    — sequence-split tokens over the "model" axis, capacity-bucketed
           scatter into per-expert slots, all_to_all over the expert-sharding
           axes (one hop an axis), local expert GEMMs, reverse all_to_all,
           weighted combine, all_gather back to the full sequence.

The port runs SPMD, one process a rank: under a mesh, ``moe_apply`` takes
the rank's own block of tokens (its ``batch_spec`` slice) and the rank's own
experts (``_e_spec``: the expert axis sharded over the chosen expert axes,
in ``_ep_rank`` order), and returns the rank's block of y and the
aux loss averaged over every rank, as the reference's ``shard_map`` body
does.  Its collectives go through ``core.collectives`` and carry gradients.
Every shape is static (capacity-overflow tokens go to a scratch row, not
through a data-dependent index), so a CUDA graph can capture the local
pieces.  The shared experts (``_shared_ffn``) compute on the rank's block
of their ``mlp`` columns where the step's layout keeps it, with a sum over
"model"; the reference's ``shard_map`` takes them replicated, whole on
every device.

Expert weights are stacked (E_pad, d, f); E is padded at config time and the
padding experts are masked in the router.  The three expert einsums go
through ``qeinsum`` with the expert axis as its batch label: with int8
weights, each is ONE launch of ``int8_matmul`` over the rank's experts, and
the dense path's token block, shared by every expert, is quantized once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as C
from repro_torch.models.layers import _dim, tp_split, tp_sum
from repro_torch.models.params import ParamDef
from repro_torch.models.quant import QuantTensor, qeinsum
from repro_torch.sharding.rules import active_mesh, axis_sizes, batch_axes


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
    """The shared-expert MLP; on the rank's block of its ``mlp`` columns
    (wg, wu column-parallel, wd row-parallel), the sum over "model" of the
    down projection."""
    from repro_torch.models.activations import get_activation

    act = get_activation(cfg.activation, cfg.activation_impl)
    g = qeinsum("bsd,df->bsf", x, shared["wg"])
    u = qeinsum("bsd,df->bsf", x, shared["wu"])
    y = qeinsum("bsf,fd->bsd", act(g) * u, shared["wd"])
    m = cfg.moe
    return tp_sum(y, tp_split(_dim(shared["wd"], 0), m.shared_d_ff * m.num_shared))


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
# sharded paths (run on each rank, on its shard)
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


def _a2a_to_experts(buf, mesh, ep_axes):
    """(E_pad, C, D) on each rank → (E_loc, C·n_ep, D) on each expert's owner.

    One all_to_all hop per expert-sharding mesh axis: split the expert axis,
    concatenate received contributions along the capacity axis (source-rank
    major) — the concat order is undone exactly by ``_a2a_from_experts``.
    """
    for ax in ep_axes:
        buf = C.all_to_all(buf, mesh, ax, split_dim=0, concat_dim=1)
    return buf


def _a2a_from_experts(buf, mesh, ep_axes):
    for ax in reversed(ep_axes):
        buf = C.all_to_all(buf, mesh, ax, split_dim=1, concat_dim=0)
    return buf


def _ep_rank(ep_axes, mesh) -> int:
    """The rank's index among the expert owners: its coordinates on
    ``ep_axes``, row-major in ``ep_axes`` order."""
    sizes = axis_sizes(mesh)
    idx = 0
    for ax in ep_axes:
        idx = idx * sizes[ax] + C.axis_index(mesh, ax)
    return idx


def _moe_sharded_body(params, x, cfg: ArchConfig, mesh, ep_axes, mode, tp_split):
    """Per-rank body. x: (B_l, S, D), the rank's shard; the expert leaves
    the rank's ``e_loc`` experts."""
    m = cfg.moe
    ep = _epad(cfg)
    sizes = axis_sizes(mesh)
    b_l, s, d = x.shape
    t_all = b_l * s
    xf = x.reshape(t_all, d)
    n_ep = math.prod(sizes[a] for a in ep_axes)
    e_loc = ep // n_ep

    if mode == "gather":
        # Few tokens: replicate them across the EP axes that shard tokens,
        # compute the local expert shard for all of them, sum-combine.
        gather_axes = tuple(a for a in ep_axes if a in batch_axes(mesh))
        xg = xf
        for ax in gather_axes:
            xg = C.all_gather(xg, mesh, ax, dim=0)
        tg = xg.shape[0]
        w, ids, probs = _router(params, xg, cfg)
        h = _expert_ffn(params["wg"], params["wu"], params["wd"],
                        xg[None].expand(e_loc, tg, d), cfg)
        gates = torch.zeros((tg, ep), dtype=torch.float32, device=x.device)
        gates = gates.scatter(1, ids, w)
        e_start = _ep_rank(ep_axes, mesh) * e_loc
        g_loc = gates[:, e_start:e_start + e_loc]
        y = torch.einsum("te,etd->td", g_loc.to(x.dtype), h)
        y = C.all_reduce(y, mesh, ep_axes)
        # slice own token block back out (inverse of the all_gathers)
        for ax in reversed(gather_axes):
            blk = y.shape[0] // sizes[ax]
            i = C.axis_index(mesh, ax)
            y = y[i * blk:(i + 1) * blk]
        aux = _aux_loss(probs, ids, cfg)
    else:  # a2a
        r = C.axis_index(mesh, "model") if tp_split > 1 else 0
        t = t_all // tp_split
        xt = xf[r * t:(r + 1) * t]
        capacity = max(1, int(math.ceil(t * m.top_k / m.num_experts * m.capacity_factor)))
        buf, route, (probs, ids) = _dispatch_local(params, xt, cfg, capacity)
        buf = _a2a_to_experts(buf, mesh, ep_axes)  # (e_loc, C·n_ep, D)
        h = _expert_ffn(params["wg"], params["wu"], params["wd"], buf, cfg)
        buf_out = _a2a_from_experts(h, mesh, ep_axes)  # (E_pad, C, D)
        y = _combine_local(buf_out, route, t, d, x.dtype)
        if tp_split > 1:
            y = C.all_gather(y, mesh, "model", dim=0)  # (t_all, D)
        aux = _aux_loss(probs, ids, cfg)

    y = y.reshape(b_l, s, d)
    if m.num_shared:
        y = y + _shared_ffn(params["shared"], x, cfg)
    denom = torch.full((), math.prod(sizes.values()), dtype=torch.float32, device=x.device)
    aux = C.all_reduce(aux, mesh, tuple(sizes)) / denom
    return y, aux


def sharded_plan(cfg: ArchConfig, mesh, local_batch: int, seq: int) -> tuple:
    """(ep_axes, mode, tp_split) for a rank's (local_batch, seq) block of
    tokens on ``mesh``: the reference's choice, from its arithmetic."""
    m = cfg.moe
    ep = _epad(cfg)
    sizes = axis_sizes(mesh)
    # expert-sharding axes actually available on this mesh
    ep_axes = tuple(a for a in m.ep_axes if a in sizes and sizes[a] > 1)
    n_ep = math.prod(sizes[a] for a in ep_axes)
    while ep_axes and ep % n_ep != 0:
        ep_axes = ep_axes[1:]
        n_ep = math.prod(sizes[a] for a in ep_axes)
    t_all = local_batch * seq
    tp = sizes.get("model", 1)
    if "model" in batch_axes(mesh):  # fsdp_only: tokens already sharded over "model" as DP
        tp = 1
    tp_split = tp if (t_all % tp == 0 and t_all // tp >= 64) else 1
    t = t_all // tp_split
    mode = "a2a" if (ep_axes and t >= 64 and t * m.top_k >= 2 * m.num_experts) else "gather"
    return ep_axes, mode, tp_split


def moe_apply(params, x, cfg: ArchConfig):
    """Returns (y, aux_loss). Picks dense / gather / a2a from the active mesh;
    under a mesh of more than one rank, ``x`` and the expert leaves are the
    rank's shards (module docstring)."""
    mesh = active_mesh()
    m = cfg.moe
    if mesh is None or math.prod(axis_sizes(mesh).values()) == 1:
        y, aux = _moe_dense(params, x, cfg)
        if m.num_shared:
            y = y + _shared_ffn(params["shared"], x, cfg)
        return y, aux
    ep_axes, mode, tp_split = sharded_plan(cfg, mesh, x.shape[0], x.shape[1])
    e_loc = _epad(cfg) // math.prod(axis_sizes(mesh)[a] for a in ep_axes)
    wg = params["wg"]
    held = (wg.q if isinstance(wg, QuantTensor) else wg).shape[0]
    if held != e_loc:
        raise ValueError(f"the rank holds {held} experts, the mesh gives it {e_loc} (_e_spec)")
    return _moe_sharded_body(params, x, cfg, mesh, ep_axes, mode, tp_split)


def _e_spec(ep_axes) -> tuple:
    """Spec of the stacked expert leaves (E_pad, ., .): E over ``ep_axes``."""
    if not ep_axes:
        return (None, None, None)
    return (ep_axes if len(ep_axes) > 1 else ep_axes[0], None, None)


def moe_collectives(cfg: ArchConfig, mesh, local_batch: int, seq: int, dtype,
                    *, backward: bool = False):
    """What one ``moe_apply`` call sends from each rank (its forward, and
    with ``backward`` its gradient's transposes), counted from the plan and
    the shapes: a ``core.collectives.CollectiveStats``."""
    stats = C.CollectiveStats()
    sizes = axis_sizes(mesh)
    if math.prod(sizes.values()) == 1:
        return stats
    m = cfg.moe
    ep = _epad(cfg)
    ep_axes, mode, tp_split = sharded_plan(cfg, mesh, local_batch, seq)
    item = torch.empty((), dtype=dtype).element_size()
    d = cfg.d_model
    t_all = local_batch * seq
    passes = 2 if backward else 1
    if mode == "gather":
        t = t_all
        for ax in (a for a in ep_axes if a in batch_axes(mesh)):
            if sizes[ax] > 1:  # all-gather forward, reduce-scatter (of n× the rows) back
                stats.add("all-gather", t * d * item)
                if backward:
                    stats.add("reduce-scatter", t * sizes[ax] * d * item)
            t *= sizes[ax]
        for ax in ep_axes:
            stats.add("all-reduce", t * d * item, passes)
    else:
        t = t_all // tp_split
        capacity = max(1, int(math.ceil(t * m.top_k / m.num_experts * m.capacity_factor)))
        buf = ep * capacity * d * item  # every hop moves the same bytes
        for ax in ep_axes:
            stats.add("all-to-all", buf, 2 * passes)
        if tp_split > 1:
            stats.add("all-gather", t * d * item)
            if backward:
                stats.add("reduce-scatter", t_all * d * item)
    for ax in sizes:
        if sizes[ax] > 1:
            stats.add("all-reduce", 4, passes)  # the aux loss, f32
    return stats
