"""Public wrappers over the ported kernels.

Where a call runs follows from where its tensors lie: CUDA tensors go
through the CUDA kernels (or raise), CPU tensors through the kernels' plain
PyTorch versions.  There is no switch that changes this.

Batch tiles default to ``"auto"``: a fixed rule
(``repro_torch.kernels.runtime.pick_block_b``) until the block-size tuner is
ported.  The attention and int8-matmul wrappers arrive with their kernels.
"""
from __future__ import annotations

from repro_torch.kernels.activations import activation as _activation
from repro_torch.kernels.lstm_cell import lstm_cell_fused as _lstm_cell
from repro_torch.kernels.lstm_seq import (
    lstm_seq_fused as _lstm_seq,
    lstm_seq_fused_q8 as _lstm_seq_q8,
    lstm_seq_fused_quantized as _lstm_seq_quantized,
    lstm_stack_fused as _lstm_stack,
)
from repro_torch.kernels.ref import quantize_colwise, quantize_rowwise  # noqa: F401


def activation(x, *, fn: str = "sigmoid", impl: str = "exact"):
    return _activation(x, fn=fn, impl=impl)


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
    layer's hs (B, S, H); inter-layer h stays in shared memory."""
    return _lstm_stack(x, layers, impl=impl, block_b=block_b, quantized=quantized,
                       return_state=return_state)
