"""Weight quantization + scale plumbing for the int8 sequence LSTM.

The paper's precision axis composes with the residency axis of
``kernels.lstm_seq``: the LSTM weights ``w`` (D, 4H) and ``u`` (H, 4H) are
what every step of the recurrence re-reads, so holding THEM as int8 cuts
that traffic, and the footprint that must fit on chip, to a quarter of f32.

Symmetric per-output-channel scales, here "per gate column": one f32 scale
per column of the packed (.., 4H) gate axis, from ``ref.quantize_colwise``.
The bias stays f32 (it is 4H elements).  Dequantization happens inside the
kernel after each product, ``(x @ w_q) * sw``: column scales commute with
the product.

Weights are PACKED before quantization (gate columns i,f,g,o → i,f,o,g,
``lstm_seq._pack_ifog``), the reference's stored layout, so that payloads and
scales are byte for byte the reference's; the kernels are told that the
columns are packed.  Since the scales are per column, packing and
quantization commute.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import quantize_colwise


class QuantizedLSTMWeights(NamedTuple):
    """One layer's packed, per-gate-column-quantized weights."""

    w_q: torch.Tensor      # (D, 4H) int8, gate columns packed [i, f, o, g]
    u_q: torch.Tensor      # (H, 4H) int8, same packing
    b: torch.Tensor        # (4H,) f32, same packing
    w_scale: torch.Tensor  # (4H,) f32 per-gate-column scales for w_q
    u_scale: torch.Tensor  # (4H,) f32 per-gate-column scales for u_q

    @property
    def hidden(self) -> int:
        return self.u_q.shape[0]


def quantize_lstm_weights(w, u, b, hidden: int | None = None) -> QuantizedLSTMWeights:
    """Pack gate columns then quantize w/u per gate column to int8.

    w: (D, 4H) f32; u: (H, 4H) f32; b: (4H,) f32 — the ``lstm_defs`` layout
    with gate order i, f, g, o. Returns packed [i, f, o, g] int8 weights +
    f32 scales, ready for the quantized ``lstm_seq`` kernels.
    """
    from repro_torch.kernels.lstm_seq import _pack_ifog

    hidden = u.shape[0] if hidden is None else hidden
    w, u, b = _pack_ifog(w, u, b, hidden)
    w_q, w_scale = quantize_colwise(w)
    u_q, u_scale = quantize_colwise(u)
    return QuantizedLSTMWeights(w_q, u_q, b.to(torch.float32), w_scale, u_scale)


def quantize_lstm_stack(layers) -> list[QuantizedLSTMWeights]:
    """Quantize a list of (w, u, b) layer triples (or param dicts)."""
    out = []
    for layer in layers:
        if isinstance(layer, dict):
            layer = (layer["w"], layer["u"], layer["b"])
        w, u, b = layer
        out.append(quantize_lstm_weights(w, u, b))
    return out


def dequantize(q: QuantizedLSTMWeights) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 (w, u, b) in PACKED gate order — the exact values the quantized
    kernels compute with (oracle for tests)."""
    w = q.w_q.to(torch.float32) * q.w_scale[None, :]
    u = q.u_q.to(torch.float32) * q.u_scale[None, :]
    return w, u, q.b


def resident_weight_bytes(d_in: int, hidden: int, dtype: str = "float32") -> float:
    """Bytes of one layer's weights at ``dtype``: the (D+H)·4H payload at 4
    or 1 bytes per element, the 4H f32 bias, and for int8 two 4H f32 scale
    vectors.  D = H = 256 gives 2,101,248 bytes in f32 and 536,576 in int8,
    a factor of 3.9.  Delegates to the block-size tuner's weight-bytes model
    (``autotune._lstm_weight_bytes``) so that the two cannot diverge."""
    if dtype not in ("float32", "int8"):
        raise ValueError(f"resident_weight_bytes: dtype must be 'float32' or 'int8', got {dtype!r}")
    from repro_torch.kernels.autotune import _lstm_weight_bytes

    return _lstm_weight_bytes({"d_in": d_in, "hidden": hidden}, dtype)
