"""Int8 weight residency for the serving path.

Conventions are the JAX package's, byte for byte: symmetric per-output-column
f32 scales, ``scale = max(|w|, 1e-8) / 127`` (``kernels.ref.quantize_colwise``),
dequantized in the f32 epilogue after the int8 product.  A projection weight
is quantized ONCE (engine init) into a :class:`QuantTensor`; each
:func:`qeinsum` call quantizes its activations per row
(``quantize_rowwise``) and contracts int8 x int8 exactly through
``kernels.int8_matmul``.

Routing: every attention/MLP projection einsum in ``models/`` goes through
``qeinsum(spec, x, w)``.  With a plain tensor ``w`` it is exactly
``torch.einsum``; with a ``QuantTensor`` it takes the int8 path.  Specs whose
weight layout does not collapse to a (K, N) product against per-column
scales fall back to dequantize-then-einsum.

Dispatch differs from the JAX package in one rule, not in numbers: there the
Pallas kernel runs only when M, K and N are multiples of 128 (a TPU tiling
constraint) and the jnp reference otherwise; here every fast-path call
launches the kernel on a CUDA tensor (it masks ragged edges) and takes the
kernel's plain version on a CPU tensor.  The int32 sum is exact, so both give
the same bits.  A spec with a batch label (the MoE expert einsums, which the
JAX package maps over the label with ``vmap``) is one row quantization of
all batch x M rows and ONE batched kernel launch; an x broadcast over the
label (``Tensor.expand``: every expert sees the same tokens) is quantized
once.  Row quantization is per row, so the bytes are those of a loop over
the label.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.ref import quantize_colwise, quantize_rowwise

QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo",                      # attention projections
    "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",     # MLA low-rank projections
    "wi", "wg", "wu", "wd",                      # MLP / MoE expert + shared
    "wz", "wx",                                  # mamba input projections
    "w_in", "w_out",                             # hybrid shared-attn adapters
})

# leading ParamDef logical axes that are stack/batch axes, not contraction
# axes: "layers" (stacked layers) and "experts" (the MoE expert axis)
_LEAD_AXES = ("layers", "experts")


class QuantTensor(NamedTuple):
    """One quantized weight: int8 payload in the ORIGINAL layout + f32
    scales over the output axes (leading stack axes kept, contraction axes
    removed)."""

    q: torch.Tensor      # int8, same shape as the source weight
    scale: torch.Tensor  # f32, shape = lead axes + output axes


def layer_of(leaf, i: int):
    """Layer ``i`` of a stacked leaf: a tensor or a :class:`QuantTensor`."""
    if isinstance(leaf, QuantTensor):
        return QuantTensor(leaf.q[i], leaf.scale[i])
    return leaf[i]


def dequantize(w: QuantTensor) -> torch.Tensor:
    """f32 weight the int8 path computes with (scales over the TRAILING axes)."""
    if tuple(w.scale.shape) != tuple(w.q.shape[w.q.dim() - w.scale.dim():]):
        raise ValueError(f"scales {tuple(w.scale.shape)} do not end the payload's shape "
                         f"{tuple(w.q.shape)}")
    return w.q.to(torch.float32) * w.scale


def quantize_weight(w: torch.Tensor, *, lead: int, n_contract: int) -> QuantTensor:
    """Collapse ``w`` (lead axes + contract axes + output axes, in that
    order) to 2D per lead index and apply ``quantize_colwise``."""
    k = math.prod(w.shape[lead:lead + n_contract])
    n_dims = tuple(w.shape[lead + n_contract:])
    w2 = w.reshape(*w.shape[:lead], k, math.prod(n_dims) if n_dims else 1)
    if lead == 0:
        q2, s2 = quantize_colwise(w2)
    else:
        flat = w2.reshape(-1, *w2.shape[lead:])
        pairs = [quantize_colwise(m) for m in flat]
        q2 = torch.stack([p[0] for p in pairs]).reshape(w2.shape)
        s2 = torch.stack([p[1] for p in pairs]).reshape(*w.shape[:lead], -1)
    return QuantTensor(q=q2.reshape(w.shape), scale=s2.reshape(*w.shape[:lead], *n_dims))


def lead_axes(logical) -> int:
    """Leading stack/batch axes of a ParamDef's logical axis names."""
    lead = 0
    while lead < len(logical) and logical[lead] in _LEAD_AXES:
        lead += 1
    return lead


def contract_axes(key: str, core_nd: int) -> int:
    """Contraction axes of a projection weight past its lead axes: 3-D
    attention output weights (h, hd, d) contract two, everything else one."""
    return core_nd - 1 if (key == "wo" and core_nd == 3) else 1


def quantize_params(params, cfg):
    """Quantize every allowlisted projection weight in a model param tree.

    The matching ``ParamDef`` tree supplies the logical axis names, which is
    how stacked lead axes (layers / experts) are told apart from contraction
    axes: shapes alone cannot.  Idempotent: quantized leaves pass through.
    """
    from repro_torch.models.model import param_defs

    defs = param_defs(cfg)

    def walk(key, p, d):
        if isinstance(p, dict):
            return {k: walk(k, v, d[k]) for k, v in p.items()}
        if key not in QUANT_KEYS or isinstance(p, QuantTensor):
            return p
        lead = lead_axes(d.logical)
        n_contract = contract_axes(key, p.dim() - lead)
        return quantize_weight(p, lead=lead, n_contract=n_contract)

    return {k: walk(k, v, defs[k]) for k, v in params.items()}


def _einsum(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the JAX package's type promotion (torch wants
    both operands of one type)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(spec, x.to(dt), w.to(dt))


def qeinsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """``torch.einsum(spec, x, w)``, int8-aware.

    Plain tensor ``w`` → einsum passthrough.  ``QuantTensor`` ``w`` →
    row-quantize ``x``, contract int8 x int8 exactly, apply both scales in
    the f32 epilogue.  Fast-path specs look like
    ``"(b)(xm...)(k...), (b)(k...)(n...) -> (b)(xm...)(n...)"`` with at most
    one shared batch label ``b`` (one product per batch index, e.g. the MoE
    expert axis); other specs dequantize the weight and run the einsum.
    """
    if not isinstance(w, QuantTensor):
        return _einsum(spec, x, w)
    ins, out = spec.replace(" ", "").split("->")
    s1, s2 = ins.split(",")
    set1, setout = set(s1), set(out)
    batch = [c for c in s2 if c in set1 and c in setout]
    contract = [c for c in s2 if c in set1 and c not in setout]
    wout = [c for c in s2 if c not in set1]
    xm = [c for c in s1 if c not in s2]
    fast = (len(batch) <= 1 and contract
            and s2 == "".join(batch + contract + wout)
            and s1 == "".join(batch + xm + contract)
            and out == "".join(batch + xm + wout))
    if not fast:
        return _einsum(spec, x, dequantize(w)).to(x.dtype)
    nm, nk, nb = len(xm), len(contract), len(batch)
    xm_shape, n_shape = tuple(x.shape[nb:nb + nm]), tuple(w.q.shape[nb + nk:])
    k = math.prod(x.shape[nb + nm:])
    if math.prod(w.q.shape[nb:nb + nk]) != k or x.shape[:nb] != w.q.shape[:nb]:
        raise ValueError(f"qeinsum {spec!r}: x {tuple(x.shape)} and w {tuple(w.q.shape)} "
                         "disagree on the contraction or the batch")
    m = math.prod(xm_shape)
    if not batch:
        xq, xs = quantize_rowwise(x.reshape(m, k))
        y = int8_matmul(xq, w.q.reshape(k, -1).contiguous(), xs.contiguous(),
                        w.scale.reshape(-1).contiguous())
        return y.reshape(*xm_shape, *n_shape).to(x.dtype)
    e = x.shape[0]
    if x.stride(0) == 0:  # one block of rows shared by every batch index: quantized once
        xq, xs = quantize_rowwise(x[0].reshape(m, k))
        xq, xs = xq.expand(e, m, k), xs.expand(e, m, 1)
    else:
        xq, xs = quantize_rowwise(x.reshape(e * m, k))
        xq, xs = xq.reshape(e, m, k), xs.reshape(e, m, 1)
    y = int8_matmul(xq, w.q.reshape(e, k, -1).contiguous(), xs,
                    w.scale.reshape(e, -1).contiguous())
    return y.reshape(e, *xm_shape, *n_shape).to(x.dtype)
