"""Plain PyTorch oracles for the ported kernels: the mathematical ground
truth, written against the SEMANTICS in ``repro_torch.models.activations``
(so the exact tanh here is ``torch.tanh``, unlike the kernels' 2σ(2x) − 1).

Oracles for the kernels that are not ported yet (attention, int8 matmul)
arrive with those kernels.
"""
from __future__ import annotations

import torch

from repro_torch.models import activations as act_mod


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def activation_ref(x: torch.Tensor, *, fn: str, impl: str) -> torch.Tensor:
    if fn == "sigmoid":
        return act_mod.get_sigmoid(impl)(x)
    if fn == "tanh":
        return act_mod.get_tanh(impl)(x)
    if fn in ("silu", "gelu"):
        return act_mod.get_activation(fn, impl)(x)
    raise ValueError(fn)


# ---------------------------------------------------------------------------
# Fused LSTM cell
# ---------------------------------------------------------------------------
def lstm_cell_ref(x, h, c, w, u, b, *, impl: str = "exact"):
    """x: (B, D); h/c: (B, H); w: (D, 4H); u: (H, 4H); b: (4H,)."""
    sig = act_mod.get_sigmoid(impl)
    tnh = act_mod.get_tanh(impl)
    z = x @ w + h @ u + b.to(x.dtype)
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    i, f, o = sig(zi), sig(zf), sig(zo)
    g = tnh(zg)
    c_new = f * c + i * g
    h_new = o * tnh(c_new)
    return h_new, c_new


# ---------------------------------------------------------------------------
# Quantized sequence LSTM (PACKED [i, f, o, g] gate layout)
# ---------------------------------------------------------------------------
def lstm_seq_q8_ref(x, w_q, u_q, b, w_scale, u_scale, *, impl: str = "exact"):
    """Recurrence oracle for the int8 kernels: weights arrive PACKED
    [i, f, o, g] and quantized per gate column (the
    ``lstm_quant.QuantizedLSTMWeights`` layout), dequantized AFTER each
    product exactly like the kernel's epilogue.

    x: (B, S, D) f32 → hs (B, S, H), final (h, c).
    """
    sig = act_mod.get_sigmoid(impl)
    tnh = act_mod.get_tanh(impl)
    bsz, seq, _ = x.shape
    hidden = u_q.shape[0]
    wf = w_q.to(torch.float32)
    uf = u_q.to(torch.float32)
    h = torch.zeros((bsz, hidden), dtype=torch.float32, device=x.device)
    c = torch.zeros((bsz, hidden), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(seq):
        z = (
            (x[:, t].to(torch.float32) @ wf) * w_scale[None, :]
            + (h @ uf) * u_scale[None, :]
            + b[None, :]
        )
        i = sig(z[:, :hidden])
        f = sig(z[:, hidden : 2 * hidden])
        o = sig(z[:, 2 * hidden : 3 * hidden])
        g = tnh(z[:, 3 * hidden :])
        c = f * c + i * g
        h = o * tnh(c)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h, c


# ---------------------------------------------------------------------------
# Symmetric int8 quantizers.  Byte-identical to the JAX package's: the scale
# is max(amax, 1e-8) / 127 in f32, the payload round-half-to-even of a TRUE
# division x / scale (not a multiply by the reciprocal), clipped to ±127.
# ---------------------------------------------------------------------------
def quantize_rowwise(x: torch.Tensor):
    """Symmetric per-row int8 quantization. Returns (x_q, scale (M,1))."""
    amax = x.to(torch.float32).abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    xq = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return xq, scale


def quantize_colwise(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization. Returns (w_q, scale (N,))."""
    amax = w.to(torch.float32).abs().amax(dim=0)
    scale = amax.clamp_min(1e-8) / 127.0
    wq = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return wq, scale
