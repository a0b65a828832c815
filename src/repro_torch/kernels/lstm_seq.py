"""Sequence LSTM — the whole recurrence in ONE CUDA launch.

The paper's C1/C2 headline comes from keeping the LSTM weights on chip and
running all four gates through one MAC array, so each timestep pays for
compute and never for re-streaming weights or state.
``lstm_cell.lstm_cell_fused`` ports the *cell* but is launched once per
timestep from a Python loop.  The kernels here (``csrc/lstm_seq.cu``) port
the *residency*:

  * the grid walks batch tiles only; the time loop runs INSIDE the kernel,
    so there is one launch per call, and ``h``/``c`` live in shared memory
    for the whole sequence;
  * both products, ``x[t] @ w`` and ``h @ u``, are computed in the kernel.
    f32 weights are read in the public gate order i,f,g,o as they are: the
    order only decides which H columns get the tanh, so nothing is permuted
    per call.  Quantized weights are stored PACKED [i, f, o, g]
    (``kernels.lstm_quant``) and the kernel is told so;
  * ``x`` is read, and ``hs`` written, in the public batch-major layout:
    the wrapper makes no time-major copy and pads nothing, the ragged last
    tile simply has fewer rows.

Where the weights live.  If one layer's ``w`` and ``u`` fit in a thread
block's shared memory beside the tile's state, the block copies them in
once and every step reads them there (the paper's shape, the small bench
widths).  If not (D = H = 256, f32 or int8), every step re-reads them from
device memory through the L2 cache; int8 cuts that traffic to a quarter.
:func:`plan_launch` makes the choice and reports it.

**int8 weights** (``lstm_seq_fused_q8`` / ``lstm_seq_fused_quantized``):
``w``/``u`` as int8 with per-gate-column f32 scales (``kernels.lstm_quant``),
converted at the load; the scale multiplies the finished sum.

**layer-fused stacks** (``lstm_stack_fused``): L layers in one launch.  The
inter-layer h sequence lives in a (S, bb, H) f32 shared-memory buffer,
written by layer l and read, row by row, by layer l+1, and never travels
through device memory, unlike L sequential ``lstm_seq_fused`` calls.  When
that buffer cannot fit even for one batch row the wrapper raises a
``ValueError`` stating the bound.

Each kernel has its plain PyTorch version here (:func:`lstm_seq_plain`,
:func:`lstm_stack_plain`), taken only for CPU tensors.

``block_b`` is the batch tile of one thread block: an int is honoured,
``"auto"`` follows the fixed rule of :func:`runtime.pick_block_b`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.activations import apply_variant_plain, impl_code
from repro_torch.kernels.lstm_cell import K_SLICES, _check_f32, _contiguous
from repro_torch.models.activations import LUT_SIZE, _sigmoid_table


@functools.lru_cache(maxsize=None)
def _ifog_index(hidden: int, device: torch.device) -> torch.Tensor:
    idx = torch.arange(4 * hidden)
    return torch.cat([idx[: 2 * hidden], idx[3 * hidden :], idx[2 * hidden : 3 * hidden]]).to(device)


def _pack_ifog(w, u, b, hidden: int):
    """Permute gate columns i,f,g,o → i,f,o,g: the stored layout of
    quantized weights (``kernels.lstm_quant``), as in the reference.  One
    gather per tensor, with the column index cached per (H, device)."""
    idx = _ifog_index(hidden, w.device)
    return w.index_select(-1, idx), u.index_select(-1, idx), b.index_select(-1, idx)


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------
def seq_smem_bytes(bb: int, seq: int, d_in: int, hidden: int, layers: int,
                   wbytes: int, resident: bool) -> int:
    """One block's shared memory (``seq_smem_bytes`` in ``csrc/lstm_seq.cu``):
    f32 table | h | c | the gates' partial sums, one (bb, 4H) slice per
    k-slice | two x[t] tiles | the (S, bb, H) inter-layer sequence
    for a stack, then one layer's ``w`` and ``u`` at ``wbytes`` per element
    when they are resident."""
    r4 = lambda n: runtime.round_up(n, 4)
    floats = LUT_SIZE + 2 * r4(bb * hidden) + K_SLICES * bb * 4 * hidden + 2 * r4(bb * d_in)
    if layers > 1:
        floats += r4(seq * bb * hidden)
    nbytes = 4 * floats
    if resident:
        w_rows = hidden if (layers > 1 and hidden > d_in) else d_in
        nbytes += runtime.round_up(w_rows * 4 * hidden * wbytes, 16)
        nbytes += runtime.round_up(hidden * 4 * hidden * wbytes, 16)
    return nbytes


class LaunchPlan(NamedTuple):
    block_b: int      # batch rows per thread block
    resident: bool    # weights copied into shared memory (else re-read each step)
    smem_bytes: int   # dynamic shared memory of one block


@functools.lru_cache(maxsize=1024)
def plan_launch(block_b, batch: int, seq: int, d_in: int, hidden: int, *,
                layers: int = 1, quantized: bool = False) -> LaunchPlan:
    """Batch tile, weight placement and shared memory for one launch.

    The tile comes from :func:`runtime.pick_block_b` over the memory the
    kernel needs WITHOUT resident weights; the weights are then made
    resident if they fit beside that tile.  Raises ``ValueError`` when even
    one batch row does not fit (for a stack: S·H·4 bytes of inter-layer
    sequence per row)."""
    wbytes = 1 if quantized else 4
    kernel = "lstm_stack" if layers > 1 else "lstm_seq"
    bb = runtime.pick_block_b(
        block_b, batch,
        lambda n: seq_smem_bytes(n, seq, d_in, hidden, layers, wbytes, False), kernel,
    )
    with_weights = seq_smem_bytes(bb, seq, d_in, hidden, layers, wbytes, True)
    if with_weights <= runtime.MAX_SHARED_BYTES:
        return LaunchPlan(bb, True, with_weights)
    return LaunchPlan(bb, False, seq_smem_bytes(bb, seq, d_in, hidden, layers, wbytes, False))


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels' arithmetic
# ---------------------------------------------------------------------------
def lstm_seq_plain(x, w, u, b, sw=None, su=None, *, impl: str = "exact", packed: bool = True):
    """One layer, f32 or int8 weights (then ``sw``, ``su`` are the per-column
    scales, applied after each product), gate columns [i, f, o, g] if
    ``packed`` else [i, f, g, o].  x: (B, S, D) → hs (B, S, H), hn, cn (B, H)."""
    bsz, seq, _ = x.shape
    hidden = u.shape[0]
    g_at, o_at = (3 * hidden, 2 * hidden) if packed else (2 * hidden, 3 * hidden)
    wf, uf = w.to(torch.float32), u.to(torch.float32)
    h = torch.zeros((bsz, hidden), dtype=torch.float32, device=x.device)
    c = torch.zeros((bsz, hidden), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(seq):
        zx = x[:, t] @ wf
        zu = h @ uf
        if sw is not None:
            zx = zx * sw[None, :]
            zu = zu * su[None, :]
        z = (zx + b[None, :]) + zu
        i = apply_variant_plain(z[:, :hidden], impl, "sigmoid")
        f = apply_variant_plain(z[:, hidden : 2 * hidden], impl, "sigmoid")
        o = apply_variant_plain(z[:, o_at : o_at + hidden], impl, "sigmoid")
        g = apply_variant_plain(z[:, g_at : g_at + hidden], impl, "tanh")
        c = f * c + i * g
        h = o * apply_variant_plain(c, impl, "tanh")
        hs.append(h)
    return torch.stack(hs, dim=1), h, c


def lstm_stack_plain(x, w0, wr, us, bs, sws=None, sus=None, *, impl: str = "exact",
                     packed: bool = True):
    """L >= 2 layers over stacked weights (the kernel's operands).  Returns
    the last layer's hs (B, S, H) and hn, cn (L, B, H)."""
    h = x
    hns, cns = [], []
    for l in range(us.shape[0]):
        h, hn, cn = lstm_seq_plain(
            h, w0 if l == 0 else wr[l - 1], us[l], bs[l],
            None if sws is None else sws[l], None if sus is None else sus[l], impl=impl,
            packed=packed,
        )
        hns.append(hn)
        cns.append(cn)
    return h, torch.stack(hns), torch.stack(cns)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------
def _check_weights(kernel: str, quantized: bool, **tensors: torch.Tensor) -> None:
    want = torch.int8 if quantized else torch.float32
    for name, t in tensors.items():
        if t.dtype != want:
            raise TypeError(f"{kernel} takes {want} weights here, got {name} of {t.dtype}")


def _lstm_seq_call(x, w, u, b, sw, su, *, impl: str, block_b, return_state: bool,
                   packed: bool = False):
    """Shared single-layer launcher. ``sw``/``su`` None → f32 weights in the
    public gate order; int8 weights arrive packed from ``lstm_quant`` and
    are not packed a second time."""
    code = impl_code(impl)
    quantized = sw is not None
    kernel = "lstm_seq_q8" if quantized else "lstm_seq_f32"
    _check_f32(kernel, x=x, b=b, **({"w_scale": sw, "u_scale": su} if quantized else {}))
    _check_weights(kernel, quantized, w=w, u=u)
    if x.dim() != 3:
        raise ValueError(f"{kernel}: x must be (B, S, D), got {tuple(x.shape)}")
    bsz, seq, d_in = x.shape
    hidden = u.shape[0]
    if w.shape != (d_in, 4 * hidden) or u.shape != (hidden, 4 * hidden) or b.shape != (4 * hidden,):
        raise ValueError(
            f"{kernel}: inconsistent shapes x {tuple(x.shape)} w {tuple(w.shape)} "
            f"u {tuple(u.shape)} b {tuple(b.shape)}"
        )
    if seq < 1:
        raise ValueError(f"{kernel}: empty sequence")
    dev = runtime.require_same_device(x, w, u, b, *((sw, su) if quantized else ()))
    plan = plan_launch(block_b, bsz, seq, d_in, hidden, quantized=quantized)

    if dev.type == "cpu":
        hs, hn, cn = lstm_seq_plain(x, w, u, b, sw, su, impl=impl, packed=packed)
    else:
        x = x.contiguous()  # a slice of a longer sequence is copied, inside the call
        _contiguous(kernel, w=w, u=u, b=b, **({"w_scale": sw, "u_scale": su} if quantized else {}))
        lib = runtime.load_kernels()
        hs = torch.empty((bsz, seq, hidden), dtype=torch.float32, device=dev)
        hn = torch.empty((bsz, hidden), dtype=torch.float32, device=dev)
        cn = torch.empty((bsz, hidden), dtype=torch.float32, device=dev)
        table = _sigmoid_table(dev)
        with runtime.device_guard(dev):
            rc = lib.repro_lstm_seq(
                x.data_ptr(), w.data_ptr(), u.data_ptr(), b.data_ptr(),
                sw.data_ptr() if quantized else None, su.data_ptr() if quantized else None,
                table.data_ptr(), hs.data_ptr(), hn.data_ptr(), cn.data_ptr(),
                bsz, seq, d_in, hidden, code, int(quantized), int(packed), plan.block_b,
                int(plan.resident), plan.smem_bytes, runtime.current_stream(),
            )
        runtime.check_launch(rc, kernel)
        runtime.count_launch(kernel)
    if return_state:
        return hs, (hn, cn)
    return hs


def lstm_seq_fused(x, w, u, b, *, impl: str = "exact", block_b: int | str = "auto",
                   return_state: bool = False):
    """Whole-sequence fused LSTM. x: (B, S, D); w: (D, 4H); u: (H, 4H);
    b: (4H,); all f32 (anything else raises), public gate order i,f,g,o.

    Returns hs (B, S, H), plus the final (h, c) when ``return_state``.
    Any B and S work.
    """
    return _lstm_seq_call(x, w, u, b, None, None, impl=impl, block_b=block_b,
                          return_state=return_state)


def lstm_seq_fused_quantized(x, qw, *, impl: str = "exact", block_b: int | str = "auto",
                             return_state: bool = False):
    """int8 sequence LSTM over pre-quantized weights.

    ``qw`` is a ``lstm_quant.QuantizedLSTMWeights`` (packed gate layout,
    per-gate-column scales); it is not packed a second time.
    """
    return _lstm_seq_call(x, qw.w_q, qw.u_q, qw.b, qw.w_scale, qw.u_scale, impl=impl,
                          block_b=block_b, return_state=return_state, packed=True)


def lstm_seq_fused_q8(x, w, u, b, *, impl: str = "exact", block_b: int | str = "auto",
                      return_state: bool = False):
    """Convenience wrapper: quantize f32 weights on the fly, then run the
    int8 kernel (deployments should pre-quantize once with
    ``lstm_quant.quantize_lstm_weights`` and call the ``_quantized``
    variant)."""
    from repro_torch.kernels.lstm_quant import quantize_lstm_weights

    return lstm_seq_fused_quantized(
        x, quantize_lstm_weights(w, u, b, u.shape[0]), impl=impl, block_b=block_b,
        return_state=return_state,
    )


def _lstm_stack_call(x, w0, wr, us, bs, sws, sus, *, impl: str, block_b, return_state: bool,
                     packed: bool):
    """Layer-fused stack launcher; layers ≥ 2.  Gate columns [i, f, o, g] if
    ``packed`` (quantized weights) else the public [i, f, g, o].

    w0: (D, 4H); wr: (L-1, H, 4H); us: (L, H, 4H); bs: (L, 4H);
    sws/sus: (L, 4H) scales or None (f32 path).
    """
    code = impl_code(impl)
    quantized = sws is not None
    kernel = "lstm_stack_q8" if quantized else "lstm_stack_f32"
    _check_f32(kernel, x=x, bs=bs, **({"w_scales": sws, "u_scales": sus} if quantized else {}))
    _check_weights(kernel, quantized, w0=w0, wr=wr, us=us)
    if x.dim() != 3:
        raise ValueError(f"{kernel}: x must be (B, S, D), got {tuple(x.shape)}")
    bsz, seq, d_in = x.shape
    layers, hidden = us.shape[0], us.shape[1]
    gates = 4 * hidden
    if (layers < 2 or w0.shape != (d_in, gates) or wr.shape != (layers - 1, hidden, gates)
            or us.shape != (layers, hidden, gates) or bs.shape != (layers, gates)):
        raise ValueError(
            f"{kernel}: inconsistent shapes x {tuple(x.shape)} w0 {tuple(w0.shape)} "
            f"wr {tuple(wr.shape)} us {tuple(us.shape)} bs {tuple(bs.shape)}"
        )
    if seq < 1:
        raise ValueError(f"{kernel}: empty sequence")
    dev = runtime.require_same_device(x, w0, wr, us, bs, *((sws, sus) if quantized else ()))
    plan = plan_launch(block_b, bsz, seq, d_in, hidden, layers=layers, quantized=quantized)

    if dev.type == "cpu":
        hs, hn, cn = lstm_stack_plain(x, w0, wr, us, bs, sws, sus, impl=impl, packed=packed)
    else:
        x = x.contiguous()
        _contiguous(kernel, w0=w0, wr=wr, us=us, bs=bs,
                    **({"w_scales": sws, "u_scales": sus} if quantized else {}))
        lib = runtime.load_kernels()
        hs = torch.empty((bsz, seq, hidden), dtype=torch.float32, device=dev)
        hn = torch.empty((layers, bsz, hidden), dtype=torch.float32, device=dev)
        cn = torch.empty((layers, bsz, hidden), dtype=torch.float32, device=dev)
        table = _sigmoid_table(dev)
        with runtime.device_guard(dev):
            rc = lib.repro_lstm_stack(
                x.data_ptr(), w0.data_ptr(), wr.data_ptr(), us.data_ptr(), bs.data_ptr(),
                sws.data_ptr() if quantized else None, sus.data_ptr() if quantized else None,
                table.data_ptr(), hs.data_ptr(), hn.data_ptr(), cn.data_ptr(),
                bsz, seq, d_in, hidden, layers, code, int(quantized), int(packed), plan.block_b,
                int(plan.resident), plan.smem_bytes, runtime.current_stream(),
            )
        runtime.check_launch(rc, kernel)
        runtime.count_launch(kernel)
    if return_state:
        return hs, (hn, cn)
    return hs


def lstm_stack_fused(x, layers, *, impl: str = "exact", block_b: int | str = "auto",
                     quantized: bool = False, return_state: bool = False):
    """L-layer layer-fused LSTM stack: ONE launch for all layers.

    x: (B, S, D); ``layers`` is a list of (w, u, b) triples (or param
    dicts): layer 0 takes w (D, 4H); layers 1..L-1 take w (H, 4H); every
    layer's u is (H, 4H).  The inter-layer h sequence stays in shared
    memory — it never round-trips through device memory the way L
    sequential ``lstm_seq_fused`` calls do.  ``quantized=True`` holds every
    layer's w/u as int8 with per-gate-column scales (``kernels.lstm_quant``).

    Returns hs (B, S, H) of the LAST layer, plus per-layer final states
    (h, c) of shape (L, B, H) when ``return_state``.
    """
    triples = [
        (l["w"], l["u"], l["b"]) if isinstance(l, dict) else l for l in layers
    ]
    if not triples:
        raise ValueError("lstm_stack_fused needs at least one layer")
    hidden = triples[0][1].shape[0]
    for w, u, b in triples[1:]:
        if w.shape != (hidden, 4 * hidden) or u.shape != (hidden, 4 * hidden):
            raise ValueError(
                f"stack layers beyond the first must be ({hidden}, {4 * hidden})"
                f"-shaped, got w {tuple(w.shape)} / u {tuple(u.shape)}"
            )

    if len(triples) == 1:  # degenerate stack: the single-layer kernel IS it
        w, u, b = triples[0]
        fn = lstm_seq_fused_q8 if quantized else lstm_seq_fused
        out = fn(x, w, u, b, impl=impl, block_b=block_b, return_state=return_state)
        if return_state:
            hs, (hn, cn) = out
            return hs, (hn[None], cn[None])
        return out

    if quantized:
        from repro_torch.kernels.lstm_quant import quantize_lstm_stack

        qs = quantize_lstm_stack(triples)
        w0 = qs[0].w_q
        wr = torch.stack([q.w_q for q in qs[1:]])
        us = torch.stack([q.u_q for q in qs])
        bs = torch.stack([q.b for q in qs])
        sws = torch.stack([q.w_scale for q in qs])
        sus = torch.stack([q.u_scale for q in qs])
    else:
        w0 = triples[0][0]
        wr = torch.stack([w for w, _, _ in triples[1:]])
        us = torch.stack([u for _, u, _ in triples])
        bs = torch.stack([b for _, _, b in triples])
        sws = sus = None
    return _lstm_stack_call(x, w0, wr, us, bs, sws, sus, impl=impl, block_b=block_b,
                            return_state=return_state, packed=quantized)
