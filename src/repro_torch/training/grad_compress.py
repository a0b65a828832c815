"""Int8-compressed gradient all-reduce.

Scheme (on each rank, over the DP axes), the reference's
(``repro.training.grad_compress``):

  q_i   = round(g_i / s_i),  s_i = amax(g_i)/127        (per rank)
  wire  = all_gather(q_i) + all_gather(s_i)             (int8 + one f32)
  out   = Σ_i q_i·s_i / n                               (local dequant-sum)

Rounding is half to even (``torch.round``, as ``jnp.round``), and the
quantizer divides by a 0-d tensor: the card's division by a Python number
multiplies by its reciprocal.  Exposed two ways: ``compressed_pmean_tree``
(a gradient tree on each rank) and ``dp_value_and_grad`` (data-parallel
value and grad whose gradient sync is compressed or exact; the weights are
replicated over the DP axes).  Every collective goes through
``core.collectives``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import collectives as C
from repro_torch.models.params import tree_flatten, tree_map, tree_unflatten
from repro_torch.sharding.rules import batch_axes


def _int8_pmean(g: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """Per-rank int8 quantize → all_gather → dequant-mean. Zero-safe."""
    gf = g.to(torch.float32)
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp_min(amax, 1e-20) / torch.full((), 127.0, device=g.device)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    for ax in axes:
        q = C.all_gather_stacked(q, mesh, ax)          # (n_ax, ...) int8 on the wire
        scale = C.all_gather_stacked(scale, mesh, ax)  # (n_ax,) f32
    qf = q.reshape((-1,) + tuple(gf.shape)).to(torch.float32)
    sf = scale.reshape(-1)
    n = torch.full((), qf.shape[0], dtype=torch.float32, device=g.device)
    out = torch.einsum("n...,n->...", qf, sf) / n
    return out.to(g.dtype)


def compressed_pmean_tree(grads, mesh, axes: tuple[str, ...]):
    """Compressed mean-all-reduce of a gradient tree (on each rank)."""
    return tree_map(lambda g: _int8_pmean(g, mesh, axes), grads)


def exact_pmean(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """The mean over ``axes`` by all-reduce."""
    n = 1
    for ax in axes:
        n *= C.axis_size(mesh, ax)
    return C.all_reduce(x, mesh, axes) / torch.full((), n, dtype=x.dtype, device=x.device)


def dp_value_and_grad(loss_fn: Callable, mesh, *, compressed: bool = True,
                      has_aux: bool = False):
    """Data-parallel value_and_grad with (optionally) compressed grad sync.

    ``loss_fn(params, batch) -> loss`` (or ``(loss, aux)``).  Each rank calls
    the returned function with the replicated params and ITS shard of the
    batch (the leading dim split over the DP axes); it returns the
    synchronized (loss, grads), or (loss, aux, grads) with ``has_aux``.
    """
    dp = batch_axes(mesh)

    def fn(params, batch):
        leaves = tree_flatten(params)
        with torch.enable_grad():
            xs = [p.detach().requires_grad_() for p in leaves]
            out = loss_fn(tree_unflatten(params, xs), batch)
            loss, aux = out if has_aux else (out, None)
            grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = tree_unflatten(params, [torch.zeros_like(x) if g is None else g
                                        for x, g in zip(xs, grads)])
        with torch.no_grad():
            loss = exact_pmean(loss.detach(), mesh, dp)
            if compressed:
                grads = compressed_pmean_tree(grads, mesh, dp)
            else:
                grads = tree_map(lambda g: exact_pmean(g, mesh, dp), grads)
            if has_aux:
                aux = tree_map(lambda a: exact_pmean(a.detach(), mesh, dp), aux)
                return loss, aux, grads
        return loss, grads

    return fn
