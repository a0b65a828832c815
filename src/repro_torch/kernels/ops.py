"""Public wrappers over the ported kernels.

Where a call runs follows from where its tensors lie: CUDA tensors go
through the CUDA kernels (or raise), CPU tensors through the kernels' plain
PyTorch versions.  There is no switch that changes this.

Block arguments default to ``"auto"``: the block-size tuner's pick
(``kernels.autotune``), resolved once per shape by the kernels' plans
(``lstm_cell.plan``, ``lstm_seq.plan_launch``, ``int8_matmul.plan``,
``flash_attention.tiles``).  An explicit value is honoured where the kernel
takes it: the LSTM kernels any batch tile whose shared memory fits,
``int8_matmul`` its built (block_m, block_n) tiles and any ``block_k`` that
is a multiple of ``BLOCK_K``, ``flash_attention`` the one tile each type is
built with.  Anything else raises a ``ValueError`` that states the bound or
names what is built.
"""
from __future__ import annotations

from repro_torch.kernels.activations import activation as _activation
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.int8_matmul import int8_matmul as _int8_matmul
from repro_torch.kernels.lstm_cell import lstm_cell_fused as _lstm_cell
from repro_torch.kernels.lstm_seq import (
    lstm_seq_fused as _lstm_seq,
    lstm_seq_fused_q8 as _lstm_seq_q8,
    lstm_seq_fused_quantized as _lstm_seq_quantized,
    lstm_stack_fused as _lstm_stack,
)
from repro_torch.kernels.ref import quantize_colwise, quantize_rowwise


def activation(x, *, fn: str = "sigmoid", impl: str = "exact"):
    return _activation(x, fn=fn, impl=impl)


def flash_attention(q, k, v, *, causal: bool = True, block_q="auto", block_k="auto"):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) → (B, H, Sq, D)."""
    return _flash(q, k, v, causal=causal, block_q=block_q, block_k=block_k)


def lstm_cell(x, h, c, w, u, b, *, impl: str = "exact", block_b="auto"):
    return _lstm_cell(x, h, c, w, u, b, impl=impl, block_b=block_b)


def lstm_seq(x, w, u, b, *, impl: str = "exact", block_b="auto",
             return_state: bool = False):
    """Sequence LSTM in one launch: x (B, S, D) → hs (B, S, H)."""
    return _lstm_seq(x, w, u, b, impl=impl, block_b=block_b, return_state=return_state)


def lstm_seq_q8(x, w, u, b, *, impl: str = "exact", block_b="auto",
                return_state: bool = False):
    """int8 sequence LSTM (quantize-on-the-fly f32 weights)."""
    return _lstm_seq_q8(x, w, u, b, impl=impl, block_b=block_b, return_state=return_state)


def lstm_seq_quantized(x, qw, *, impl: str = "exact", block_b="auto",
                       return_state: bool = False):
    """int8 sequence LSTM over pre-quantized weights
    (``lstm_quant.QuantizedLSTMWeights``)."""
    return _lstm_seq_quantized(x, qw, impl=impl, block_b=block_b, return_state=return_state)


def lstm_stack(x, layers, *, impl: str = "exact", block_b="auto",
               quantized: bool = False, return_state: bool = False):
    """Layer-fused L-layer LSTM stack in one launch: x (B, S, D) → last
    layer's hs (B, S, H); the inter-layer h sequence stays inside the launch,
    in shared memory (block and L2 paths) or in a (B, S, H) workspace that
    stays in L2 (cluster path)."""
    return _lstm_stack(x, layers, impl=impl, block_b=block_b, quantized=quantized,
                       return_state=return_state)


def int8_matmul(x_q, w_q, x_scale, w_scale, *, block_m="auto", block_n="auto", block_k="auto"):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: (M, 1); w_scale: (N,) → (M, N) f32."""
    return _int8_matmul(x_q, w_q, x_scale, w_scale, block_m=block_m, block_n=block_n,
                        block_k=block_k)


def quantized_matmul(x, w, **kw):
    """Quantize-on-the-fly f32/bf16 matmul through the int8 kernel."""
    xq, sx = quantize_rowwise(x)
    wq, sw = quantize_colwise(w)
    return int8_matmul(xq, wq, sx, sw, **kw).to(x.dtype)
