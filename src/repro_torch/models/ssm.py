"""Mamba2 (SSD — state-space duality) blocks: chunked prefill path + O(1)
decode, in plain torch ops as the JAX package does them in plain jnp.

The SSD algorithm (Dao & Gu, 2024) computes the scalar-decay SSM

    h_t = exp(dt_t * A) · h_{t-1} + dt_t · x_t ⊗ B_t          (per head)
    y_t = C_t · h_t + D · x_t

as a chunked dual form: a quadratic attention-like product inside each
length-L chunk plus a small inter-chunk state recurrence.

As in the JAX package:
  * ``in_proj`` is five separate matrices (z/x/B/C/dt); ``wz``, ``wx`` and
    ``wo`` are int8 projections under ``quant="int8"`` (``qeinsum``), the
    small ``wB``/``wC``/``wdt`` products stay in the weights' type.
  * n_groups = 1 (B/C shared across heads), as in mamba2-780m and zamba2.
  * All SSM arithmetic in float32, cast back to the activation type at the
    end.  ``softplus`` is ``logaddexp(x, 0)`` (``jax.nn.softplus``), not
    ``torch.nn.functional.softplus``, which returns x above its threshold.
  * ``ssm_reference`` is the sequential oracle the tests hold the chunked
    path to; ``ssd_states`` the per-position snapshots of the JAX package's
    verify path, held to it by the tests.

Tensor parallelism (the train step on a mesh, ``training.train_loop.
MeshLayout``): given the rank's "model" block of the block's leaves,
``mamba_apply`` and ``mamba_prefill_apply`` compute on its heads, as the
reference's partitioned step does: wz, wx and the x conv by ``inner``
(channels), wdt, A_log, dt_bias and D by ``ssm_heads``, wB, wC and the B/C
convs whole (one group, shared by every head), the SSD scan over the local
heads, the norm over the whole d_inner (its sum of squares summed over
"model", each rank scaling by its block of the whole ``scale``), wo
row-parallel and the sum over "model" (``layers.tp_sum``).  A rank holds
whole heads (``_inner_split`` raises otherwise).  ``mamba_decode_apply``
does the same on the rank's block of the ``state`` cache (split on
``ssm_heads`` with the leaves); its ``conv`` cache is whole, and the step's
new x-channel row is gathered over "model" so that every rank's ``conv``
is one device's.  The chunk and verify forms serve one device: whole
leaves.

Differences, deliberate:
  * ``mamba_prefill_apply`` left-pads the conv tail with zeros to W-1 rows
    when the prompt is shorter than that (the JAX package returns fewer
    rows); that is the tail chunked prefill of the same prompt carries, so a
    one- or two-token prompt decodes as it does after chunked prefill.
  * Speculative verify keeps no per-position snapshots.  ``mamba_verify_apply``
    leaves the cache untouched and returns a :class:`VerifyCarry`: the
    window's raw conv inputs and the per-step terms of the recurrence (a few
    MB a layer).  ``mamba_verify_commit`` then writes, in place, the conv
    tail and state after each row's accepted count: the tail is a slice of
    the window, the state is recomputed from the untouched state and those
    terms, the formula ``ssd_states`` evaluates at every position.  The JAX
    package materialises all T states of every layer, (L, B, T, H, P, N) in
    f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    _dim,
    own_block,
    rmsnorm,
    rmsnorm_defs,
    tp_gather,
    tp_split,
    tp_sum,
)
from repro_torch.models.params import ParamDef
from repro_torch.models.quant import qeinsum, _einsum


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
def mamba_defs(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.num_heads(d)
    n = s.state_size
    w = s.conv_width
    f32 = torch.float32
    return {
        "wz": ParamDef((d, di), ("embed", "inner")),
        "wx": ParamDef((d, di), ("embed", "inner")),
        "wB": ParamDef((d, n), ("embed", None)),
        "wC": ParamDef((d, n), ("embed", None)),
        "wdt": ParamDef((d, h), ("embed", "ssm_heads")),
        # depthwise causal convs over the x/B/C streams (width w)
        "conv_x": ParamDef((w, di), (None, "inner"), init="normal"),
        "conv_x_b": ParamDef((di,), ("inner",), init="zeros"),
        "conv_B": ParamDef((w, n), (None, None), init="normal"),
        "conv_B_b": ParamDef((n,), (None,), init="zeros"),
        "conv_C": ParamDef((w, n), (None, None), init="normal"),
        "conv_C_b": ParamDef((n,), (None,), init="zeros"),
        "A_log": ParamDef((h,), ("ssm_heads",), init="scalar_log", dtype=f32),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros", dtype=f32),
        "D": ParamDef((h,), ("ssm_heads",), init="ones", dtype=f32),
        "norm": rmsnorm_defs(di),
        "wo": ParamDef((di, d), ("inner", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``, with no
    threshold past which x is returned as it is."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x.to(torch.float32))


# ---------------------------------------------------------------------------
# Causal depthwise conv (full-sequence + incremental forms)
# ---------------------------------------------------------------------------
def _taps(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, t: int) -> torch.Tensor:
    """silu(sum_i xp[:, i:i+t] * w[i] + b) in f32, the taps added in order."""
    out = torch.zeros((xp.shape[0], t, xp.shape[2]), dtype=torch.float32, device=xp.device)
    for i in range(w.shape[0]):  # width is 4: unrolled taps, no conv primitive
        out = out + xp[:, i:i + t].to(torch.float32) * w[i].to(torch.float32)
    return torch.nn.functional.silu(out + b.to(torch.float32))


def _causal_conv(x, w, b):
    """x: (B, S, C), w: (W, C) depthwise, left-padded causal + silu."""
    width = w.shape[0]
    pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    return _taps(torch.cat([pad, x], dim=1), w, b, x.shape[1]).to(x.dtype)


def _conv_chunk(tail, raw, w, b):
    """Causal depthwise conv over a T-token chunk with a carried raw tail.

    tail: (B, W-1, C) — the raw inputs immediately preceding the chunk (zeros
    for the first chunk, matching ``_causal_conv``'s left zero-padding).
    raw: (B, T, C).  Returns (silu(conv), new_tail)."""
    width = w.shape[0]
    xp = torch.cat([tail.to(raw.dtype), raw], dim=1)  # (B, W-1+T, C)
    return _taps(xp, w, b, raw.shape[1]).to(raw.dtype), xp[:, -(width - 1):, :]


def _conv_step(conv_state, x_new, w, b):
    """Incremental conv.  conv_state: (B, W-1, C); x_new: (B, 1, C)."""
    window = torch.cat([conv_state.to(x_new.dtype), x_new], dim=1)  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window.to(torch.float32), w.to(torch.float32))
    out = torch.nn.functional.silu(out + b.to(torch.float32))[:, None, :].to(x_new.dtype)
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# SSD chunked scan (prefill / chunked prefill / verify)
# ---------------------------------------------------------------------------
def _masked_exp(keep: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """exp(diff) where ``keep``, else 0.  The masked entries' argument is
    replaced by 0 before the exp: where diff > 0 off the mask, exp(diff)
    overflows to inf, and a ``where`` after the exp alone gives the forward
    its 0 but the gradient 0 · inf = NaN (the reference's SSD scan does
    this: its gradients are NaN).  Kept entries are the same bits."""
    zero = torch.zeros((), dtype=diff.dtype, device=diff.device)
    return torch.where(keep, torch.exp(torch.where(keep, diff, zero)), zero)


def _segments(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j) for i >= j, else 0, over axis -2 of ``cum``
    (..., L, H) → (..., L_i, L_j, H).  Above the diagonal diff > 0, so the
    exp is masked on both sides (``_masked_exp``)."""
    n = cum.shape[-2]
    diff = cum[..., :, None, :] - cum[..., None, :, :]
    tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=cum.device))[..., None]
    return _masked_exp(tri, diff)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD.  All inputs float32.

    x:  (B, S, H, P)   per-head inputs
    dt: (B, S, H)      post-softplus timestep
    A:  (H,)           negative per-head decay rate
    Bm: (B, S, N)      input projection (shared across heads, n_groups=1)
    Cm: (B, S, N)      output projection
    h0: (B, H, P, N)   the state entering the sequence (zeros if None)
    Returns (y: (B, S, H, P), h_final: (B, H, P, N)).
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk != 0:
        chunk = s  # the JAX package's single-chunk fallback
    nc = s // chunk

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dtc * A, dim=2)  # (B, nc, L, H), <= 0

    # -- intra-chunk (quadratic dual form) ----------------------------------
    seg = _segments(cum)  # (B, nc, L_i, L_j, H)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    m = cb[..., None] * seg * dtc[:, :, None, :, :]  # [b, c, i, j, h]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # -- chunk-final states --------------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, L, H)
    hc = torch.einsum("bclhp,bcln->bchpn", (decay_to_end * dtc)[..., None] * xc, Bc)

    # -- inter-chunk recurrence (a short loop over nc) ------------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    h_prev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if h0 is None \
        else h0
    h_in = []  # the state entering each chunk
    for c in range(nc):
        h_in.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + hc[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, H, P, N)

    # -- inter-chunk output contribution -------------------------------------
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, h_in) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(b, s, h, p), h_prev


def ssd_states(x, dt, A, Bm, Cm, h0):
    """Single-chunk SSD that also returns the state AFTER every position
    (the JAX package's verify path; here the tests' oracle of
    ``ssd_state_at``):

        h_i = exp(cum_i)·h0 + Σ_{j≤i} exp(cum_i - cum_j)·dt_j·(x_j ⊗ B_j)

    x: (B,T,H,P), dt: (B,T,H), A: (H,), Bm/Cm: (B,T,N), h0: (B,H,P,N).
    Returns (y: (B,T,H,P), h_all: (B,T,H,P,N)) with h_all[:, i] the state
    after consuming i+1 tokens; y_i = C_i · h_i.
    """
    cum = torch.cumsum(dt * A, dim=1)
    seg = _segments(cum)  # (B, T_i, T_j, H)
    contrib = (dt[..., None] * x)[..., None] * Bm[:, :, None, None, :]  # dt_j · x_j ⊗ B_j
    h_all = torch.einsum("bijh,bjhpn->bihpn", seg, contrib)
    h_all = h_all + torch.exp(cum)[..., None, None] * h0[:, None]
    y = torch.einsum("bthpn,btn->bthp", h_all, Cm)
    return y, h_all


def ssd_state_at(cum, u, Bm, h0, idx):
    """The state after ``idx[b] + 1`` tokens of row b, from the state ``h0``
    before them: ``ssd_states``' h_all[b, idx[b]] without the other
    positions.  cum: (B,T,H) the cumulated dt·A; u: (B,T,H,P) dt·x; Bm:
    (B,T,N); h0: (B,H,P,N); idx: (B,) integers in [0, T)."""
    rows = torch.arange(cum.shape[0], device=cum.device)
    at = cum[rows, idx]  # (B, H)
    steps = torch.arange(cum.shape[1], device=cum.device)
    keep = (steps[None, :] <= idx[:, None])[..., None]  # (B, T, 1)
    w = _masked_exp(keep, at[:, None, :] - cum)  # (B, T, H); > 0 past idx, masked
    h = torch.einsum("bjhp,bjn->bhpn", w[..., None] * u, Bm)
    return h + torch.exp(at)[..., None, None] * h0


def ssm_reference(x, dt, A, Bm, Cm, h0=None):
    """Sequential oracle: literal per-step recurrence (tests only)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    hs = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * A)  # (B, H)
        hs = hs * da[:, :, None, None] + (dt[:, t, :, None] * x[:, t])[..., None] \
            * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hs, Cm[:, t]))
    return torch.stack(ys, dim=1), hs  # (B,S,H,P), (B,H,P,N)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _project(params, x, cfg: ArchConfig):
    z = qeinsum("bsd,di->bsi", x, params["wz"])
    xs = qeinsum("bsd,di->bsi", x, params["wx"])
    Bm = _einsum("bsd,dn->bsn", x, params["wB"])
    Cm = _einsum("bsd,dn->bsn", x, params["wC"])
    dt = _einsum("bsd,dh->bsh", x, params["wdt"])
    return z, xs, Bm, Cm, dt


def _split(conv_state, cfg: ArchConfig):
    """The x/B/C parts of a stacked (B, W-1, d_inner+2N) conv tail."""
    di, st = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.state_size
    return conv_state[:, :, :di], conv_state[:, :, di:di + st], conv_state[:, :, di + st:]


def _ssd_inputs(params, xs, dt, cfg: ArchConfig):
    """(x per head f32, dt after softplus, A) of a (B, T) block, on the
    heads the block holds."""
    b, t, _ = xs.shape
    xh = xs.reshape(b, t, -1, cfg.ssm.head_dim).to(torch.float32)
    dtf = softplus(dt.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"].to(torch.float32))
    return xh, dtf, A


def _inner_split(params, cfg: ArchConfig):
    """``tp_split`` of the block's d_inner columns (wo's rows), checked
    against the heads it holds (wdt's columns): a rank holds whole heads,
    ``head_dim`` columns each."""
    s = cfg.ssm
    local, heads = _dim(params["wo"], 0), _dim(params["wdt"], 1)
    if heads * s.head_dim != local:
        raise ValueError(f"the block holds {local} of d_inner's columns and {heads} heads of "
                         f"{s.head_dim}: a rank holds whole heads")
    return tp_split(local, s.d_inner(cfg.d_model))


def _split_rmsnorm(params, y, split, whole: int, eps: float):
    """``rmsnorm`` over a d_inner split over "model": the mean of squares is
    the sum over "model" of the ranks' partial sums (f32), over ``whole``;
    each rank scales its columns by its block of the whole ``scale``."""
    yf = y.to(torch.float32)
    squares = tp_sum(torch.sum(yf * yf, dim=-1, keepdim=True), split)
    n = y.shape[-1]
    scale = params["scale"][split[1] * n:(split[1] + 1) * n]
    return (yf * torch.rsqrt(squares / whole + eps) * scale).to(y.dtype)


def _gate_out(params, y, xh, z, x, cfg: ArchConfig):
    """D skip, the z gate, the norm and the output projection; on the rank's
    heads the norm across "model" and wo row-parallel, summed over
    "model"."""
    b, t = x.shape[:2]
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(b, t, -1).to(x.dtype)
    y = y * _silu_f32(z).to(x.dtype)
    split = _inner_split(params, cfg)
    if split is None:
        y = rmsnorm(params["norm"], y, cfg.norm_eps)
    else:
        y = _split_rmsnorm(params["norm"], y, split, cfg.ssm.d_inner(cfg.d_model), cfg.norm_eps)
    return tp_sum(qeinsum("bsi,id->bsd", y, params["wo"]), split)


def mamba_apply(params, x, cfg: ArchConfig):
    """Full-sequence Mamba2 block.  x: (B, S, D) → (B, S, D)."""
    return mamba_prefill_apply(params, x, cfg)[0]


def mamba_prefill_apply(params, x, cfg: ArchConfig):
    """Full-sequence pass that also returns the decode cache.

    Returns (out, conv_tail, h_final):
      conv_tail: (B, W-1, d_inner + 2N) — the last W-1 *raw* projected x/B/C
                 values (the incremental conv consumes raw inputs), zeros on
                 the left where the prompt is shorter than W-1.
      h_final:   (B, H, P, N) final SSM state.
    """
    s = cfg.ssm
    w = s.conv_width
    z, xs_raw, B_raw, C_raw, dt = _project(params, x, cfg)
    raw = torch.cat([xs_raw, B_raw, C_raw], dim=-1)
    pad = torch.zeros((raw.shape[0], w - 1, raw.shape[2]), dtype=raw.dtype, device=raw.device)
    tail = torch.cat([pad, raw], dim=1)[:, -(w - 1):]
    xs = _causal_conv(xs_raw, params["conv_x"], params["conv_x_b"])
    Bm = _causal_conv(B_raw, params["conv_B"], params["conv_B_b"])
    Cm = _causal_conv(C_raw, params["conv_C"], params["conv_C_b"])
    xh, dtf, A = _ssd_inputs(params, xs, dt, cfg)
    y, h_final = ssd_chunked(xh, dtf, A, Bm.to(torch.float32), Cm.to(torch.float32),
                             s.chunk_size)
    return _gate_out(params, y, xh, z, x, cfg), tail, h_final


def _chunk_conv(params, conv_state, xs_raw, B_raw, C_raw, cfg: ArchConfig):
    """The three convs of a chunk over the carried tail: (xs, Bm, Cm, the
    new (B, W-1, d_inner+2N) tail in the cache's type)."""
    cs_x, cs_B, cs_C = _split(conv_state, cfg)
    xs, cs_x = _conv_chunk(cs_x, xs_raw, params["conv_x"], params["conv_x_b"])
    Bm, cs_B = _conv_chunk(cs_B, B_raw, params["conv_B"], params["conv_B_b"])
    Cm, cs_C = _conv_chunk(cs_C, C_raw, params["conv_C"], params["conv_C_b"])
    return xs, Bm, Cm, torch.cat([cs_x, cs_B, cs_C], dim=-1).to(conv_state.dtype)


def mamba_chunk_apply(params, x, conv_state, ssm_state, cfg: ArchConfig):
    """Chunked prefill: T tokens with carried conv tail + SSM state.

    x: (B, T, D).  The conv consumes the previous W-1 *raw* projected values
    (``conv_state``, the layout the decode step keeps) and the SSD scan
    starts from ``ssm_state``, so successive chunks compose to the
    recurrence ``mamba_prefill_apply`` computes.  Returns (out,
    new_conv_state, new_ssm_state); the inputs are not written."""
    z, xs_raw, B_raw, C_raw, dt = _project(params, x, cfg)
    xs, Bm, Cm, new_conv = _chunk_conv(params, conv_state, xs_raw, B_raw, C_raw, cfg)
    xh, dtf, A = _ssd_inputs(params, xs, dt, cfg)
    y, h_final = ssd_chunked(xh, dtf, A, Bm.to(torch.float32), Cm.to(torch.float32),
                             cfg.ssm.chunk_size, h0=ssm_state.to(torch.float32))
    return _gate_out(params, y, xh, z, x, cfg), new_conv, h_final.to(ssm_state.dtype)


class VerifyCarry(NamedTuple):
    """What ``mamba_verify_commit`` needs of a verify window of T tokens:

    window: (B, W-1+T, d_inner+2N) the carried raw tail, then the window's
            raw x/B/C inputs, in the conv cache's type
    cum:    (B, T, H) f32 cumulated dt·A
    u:      (B, T, H, P) f32 dt·x
    Bm:     (B, T, N) f32 B after its conv
    """

    window: torch.Tensor
    cum: torch.Tensor
    u: torch.Tensor
    Bm: torch.Tensor


def mamba_verify_apply(params, x, conv_state, ssm_state, cfg: ArchConfig):
    """Speculative-verify pass: T candidate tokens in ONE chunk pass.

    The same math as ``mamba_chunk_apply`` (carried raw conv tail + SSD from
    ``ssm_state``), with the caches left as they are: returns (out,
    :class:`VerifyCarry`), from which ``mamba_verify_commit`` writes the
    tail and state after each row's accepted count (the JAX package's
    ``conv_all[:, a]`` and ``h_all[:, a]``)."""
    z, xs_raw, B_raw, C_raw, dt = _project(params, x, cfg)
    xs, Bm, Cm, _ = _chunk_conv(params, conv_state, xs_raw, B_raw, C_raw, cfg)
    window = torch.cat([conv_state, torch.cat([xs_raw, B_raw, C_raw], dim=-1).to(
        conv_state.dtype)], dim=1)
    xh, dtf, A = _ssd_inputs(params, xs, dt, cfg)
    Bf = Bm.to(torch.float32)
    y, _ = ssd_chunked(xh, dtf, A, Bf, Cm.to(torch.float32), x.shape[1],
                       h0=ssm_state.to(torch.float32))
    carry = VerifyCarry(window, torch.cumsum(dtf * A, dim=1), dtf[..., None] * xh, Bf)
    return _gate_out(params, y, xh, z, x, cfg), carry


def mamba_verify_commit(carry: VerifyCarry, accepted, conv_state, ssm_state,
                        cfg: ArchConfig) -> None:
    """Roll the caches of a verified window forward to each row's accepted
    count, in place: a = accepted[b] accepted drafts means a+1 tokens of
    the window were consumed, so row b's conv tail becomes rows
    [a+1, a+W) of ``carry.window`` and its state the one after a+1 tokens,
    recomputed from ``ssm_state`` (still the state before the window)."""
    w = cfg.ssm.conv_width
    idx = accepted.to(torch.int64)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    tail = carry.window[rows, idx[:, None] + 1 + torch.arange(w - 1, device=idx.device)]
    h = ssd_state_at(carry.cum, carry.u, carry.Bm, ssm_state.to(torch.float32), idx)
    conv_state.copy_(tail)
    ssm_state.copy_(h)


def mamba_decode_apply(params, x, conv_state, ssm_state, cfg: ArchConfig):
    """One-token decode.  x: (B, 1, D).

    conv_state: (B, W-1, d_inner + 2N) stacked x/B/C conv windows.
    ssm_state:  (B, H, P, N)
    Returns (out, new_conv_state, new_ssm_state), O(1) in context length;
    the inputs are not written.  On the rank's heads (``_inner_split``) the
    state holds those heads and the conv windows are whole: the rank's
    x-channels convolve its columns of them, and the new x row is gathered
    over "model" into the new whole windows.
    """
    split = _inner_split(params, cfg)
    if conv_state.shape[-1] != conv_channels(cfg) or ssm_state.shape[1] != _dim(
            params["wdt"], 1):
        raise ValueError(f"conv {tuple(conv_state.shape)} and state {tuple(ssm_state.shape)} "
                         f"for {_dim(params['wdt'], 1)} heads: the conv cache is whole, the "
                         f"state holds the block's heads")
    z, x_row, Bm, Cm, dt = _project(params, x, cfg)
    window_x, cs_B, cs_C = _split(conv_state, cfg)
    xs, cs_x = _conv_step(own_block(window_x, split, x_row.shape[-1], 2), x_row,
                          params["conv_x"], params["conv_x_b"])
    Bm, cs_B = _conv_step(cs_B, Bm, params["conv_B"], params["conv_B_b"])
    Cm, cs_C = _conv_step(cs_C, Cm, params["conv_C"], params["conv_C_b"])
    if split is not None:  # the whole x window, as ``_conv_step`` moves it on one device
        row = tp_gather(x_row, split, 2)
        cs_x = torch.cat([window_x.to(row.dtype), row], dim=1)[:, 1:, :]
    new_conv = torch.cat([cs_x, cs_B, cs_C], dim=-1).to(conv_state.dtype)

    xh, dtf, A = _ssd_inputs(params, xs, dt, cfg)  # (B, 1, H, P), (B, 1, H)
    xh, dtf = xh[:, 0], dtf[:, 0]
    da = torch.exp(dtf * A)  # (B, H)
    h_new = ssm_state.to(torch.float32) * da[:, :, None, None] \
        + (dtf[:, :, None] * xh)[..., None] * Bm[:, 0, None, None, :].to(torch.float32)
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm[:, 0].to(torch.float32))
    return _gate_out(params, y[:, None], xh[:, None], z, x, cfg), new_conv, \
        h_new.to(ssm_state.dtype)


def conv_channels(cfg: ArchConfig) -> int:
    s = cfg.ssm
    return s.d_inner(cfg.d_model) + 2 * s.state_size
