"""Cross-framework parity of the LSTM kernel modules: the same numpy inputs
and weights through the JAX functions (Pallas in interpret mode) and through
the port's wrappers (on the CPU: the kernels' plain PyTorch versions).

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for f32, 1e-4 for
int8 weights.  ``impl="lut"`` is discontinuous at every table bin: a
pre-activation that differs in its last bits between two summation orders
can land in the neighbouring table bin (one table step, up to ~8e-3 on a
sigmoid) and feed the next time step.  Its rule has two parts: at most 0.1%
of the elements above the tolerance, none above 2e-2.

``impl="pwl"`` (PLAN) is discontinuous at one point of each function, the
reference's own behaviour (``test_pwl_jumps_are_the_references``): a
recurrence whose float64 run passes within ``PWL_NEAR`` of a jump may take
either side of it in f32, so the sequence tests hold such a batch row to
``PWL_FLIP_ERR`` and every other row to the tolerance (``pwl_near_rows``).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lstm_quant as jq
from repro.models import activations as jact
from repro.kernels import lstm_seq as jseq
from repro.kernels import ref as jref
from repro.kernels.lstm_cell import lstm_cell_fused as j_lstm_cell
from repro_torch.kernels import lstm_quant as tq
from repro_torch.kernels import lstm_seq as tseq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import lstm_cell as cell_mod
from repro_torch.kernels import runtime
from repro_torch.kernels.lstm_cell import cell_smem_bytes
from repro_torch.kernels.lstm_cell import lstm_cell_fused as t_lstm_cell
from repro_torch.models import activations as tact

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

IMPLS = ["exact", "pwl", "lut", "hard"]

# PLAN's pieces do not meet at one point: sigmoid_pwl at |z| = 2.375, where
# 0.125·2.375 + 0.625 = 0.921875 falls to 0.03125·2.375 + 0.84375 =
# 0.91796875 (2^-8), and so tanh_pwl = 2·sigmoid_pwl(2x) − 1 at |x| = 1.1875
# (2^-7).  Its other breakpoints (1, 5; tanh's 0.5, 2.5) are continuous.
PWL_JUMPS = {"sigmoid": (2.375, 2.0 ** -8), "tanh": (1.1875, 2.0 ** -7)}
# A float64 pre-activation this close to a jump can fall on either side of it
# in f32: ~40 ulps at 2.375, and 2.4x the 4.1e-6 by which an f32 recurrence's
# pre-activations drift from the float64 ones over the int8 case of
# test_lstm_seq_cluster_shape_matches_jax (H = 256) before any flip.
PWL_NEAR = 1e-5
# What a row that passes that close is held to: one flip moves a gate or
# tanh(c) by at most one 2^-7 jump, which the remaining steps carry (f < 1
# damps it in c); the largest measured on such a row is 8.2e-4.
PWL_FLIP_ERR = 2.0 ** -7


def _pwl_sigmoid64(z):
    a = np.abs(z)
    y = np.where(a >= 5.0, 1.0, np.where(a >= 2.375, 0.03125 * a + 0.84375,
                                         np.where(a >= 1.0, 0.125 * a + 0.625, 0.25 * a + 0.5)))
    return np.where(z >= 0, y, 1.0 - y)


def pwl_near_rows(x, layers, packed=False):
    """Batch rows whose ``impl="pwl"`` recurrence, recomputed in float64
    (the plain version's arithmetic), brings a sigmoid gate's pre-activation,
    the tanh gate's or the cell state within ``PWL_NEAR`` of its jump.
    ``layers``: ``(w, u, b)`` or ``(w, u, b, w_scale, u_scale)`` numpy tuples
    (int8 weights with their per-column scales), gate columns [i, f, o, g]
    if ``packed`` else [i, f, g, o]; a stack runs them one after another."""
    (sig_at, _), (tanh_at, _) = PWL_JUMPS["sigmoid"], PWL_JUMPS["tanh"]
    h_in = np.asarray(x, np.float64)
    near = np.zeros(h_in.shape[0], bool)
    for layer in layers:
        w, u, b = (np.asarray(a, np.float64) for a in layer[:3])
        if len(layer) == 5:
            w, u = w * np.asarray(layer[3], np.float64), u * np.asarray(layer[4], np.float64)
        hidden = u.shape[0]
        g_at, o_at = (3 * hidden, 2 * hidden) if packed else (2 * hidden, 3 * hidden)
        h = c = np.zeros((h_in.shape[0], hidden))
        hs = []
        for t in range(h_in.shape[1]):
            z = h_in[:, t] @ w + b + h @ u
            gates = [z[:, :hidden], z[:, hidden:2 * hidden], z[:, o_at:o_at + hidden]]
            zg = z[:, g_at:g_at + hidden]
            i, f, o = (_pwl_sigmoid64(zz) for zz in gates)
            c = f * c + i * (2.0 * _pwl_sigmoid64(2.0 * zg) - 1.0)
            h = o * (2.0 * _pwl_sigmoid64(2.0 * c) - 1.0)
            hs.append(h)
            dist = np.minimum(np.abs(np.abs(np.concatenate(gates, 1)) - sig_at).min(1),
                              np.abs(np.abs(np.concatenate([zg, c], 1)) - tanh_at).min(1))
            near |= dist < PWL_NEAR
        h_in = np.stack(hs, 1)
    return near


def assert_parity(got, want, impl, tol, what="", near=None, axis=0):
    """``near``: for ``impl="pwl"``, the batch rows (along ``axis``) that
    ``pwl_near_rows`` found, held to ``PWL_FLIP_ERR`` instead of ``tol``."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if impl != "lut":
        if impl == "pwl" and near is not None and near.any():
            err = np.moveaxis(np.abs(got - want), axis, 0)
            lim = np.moveaxis(tol + tol * np.abs(want), axis, 0)
            assert (err[~near] <= lim[~near]).all(), (what, float(err[~near].max()))
            assert err[near].max() <= PWL_FLIP_ERR, (what, float(err[near].max()))
            return
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)
        return
    err = np.abs(got - want)
    above = err > tol + tol * np.abs(want)
    assert err.max() <= 2e-2, (what, float(err.max()))
    assert above.mean() <= 1e-3, (what, float(above.mean()))


def _weights(seed, d, hidden, layers=None):
    rng = np.random.default_rng(seed)

    def one(d_in):
        return ((rng.standard_normal((d_in, 4 * hidden)) * 0.3).astype(np.float32),
                (rng.standard_normal((hidden, 4 * hidden)) * 0.3).astype(np.float32),
                (rng.standard_normal((4 * hidden,)) * 0.1).astype(np.float32))

    if layers is None:
        return one(d)
    return [one(d if l == 0 else hidden) for l in range(layers)]


def _x(seed, *shape):
    return np.random.default_rng(100 + seed).standard_normal(shape).astype(np.float32)


def _q(qw):
    """A ``QuantizedLSTMWeights``' tensors as the numpy tuple ``pwl_near_rows`` takes."""
    return tuple(a.numpy() for a in (qw.w_q, qw.u_q, qw.b, qw.w_scale, qw.u_scale))


def _near(impl, x, layers, packed=False):
    return pwl_near_rows(x, layers, packed) if impl == "pwl" else None


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("fn", ["sigmoid", "tanh"])
def test_pwl_jumps_are_the_references(fn):
    """Both packages' PLAN functions on f32 inputs 8 ulps either side of
    every breakpoint: equal bit for bit, continuous at all but one
    breakpoint |x|, and there a step of 2^-8 (sigmoid) / 2^-7 (tanh)."""
    at, jump = PWL_JUMPS[fn]
    breaks = (1.0, 2.375, 5.0) if fn == "sigmoid" else (0.5, 1.1875, 2.5)
    for bp in breaks:
        for sign in (1.0, -1.0):
            grid = np.array([sign * bp], np.float32)
            for _ in range(8):
                grid = np.concatenate([np.nextafter(grid[:1], np.float32(0)), grid,
                                       np.nextafter(grid[-1:], np.float32(sign * np.inf))])
            grid = np.sort(grid)
            want = np.asarray(getattr(jact, f"{fn}_pwl")(jnp.asarray(grid)))
            got = getattr(tact, f"{fn}_pwl")(torch.from_numpy(grid)).numpy()
            assert got.dtype == np.float32 and np.array_equal(got.view(np.int32),
                                                               want.view(np.int32)), (fn, bp)
            steps = np.abs(np.diff(got.astype(np.float64)))
            if bp == at:
                assert abs(steps.max() - jump) <= 1e-6, (fn, sign * bp, steps.max())
                assert np.sort(steps)[-2] <= 1e-6
            else:
                assert steps.max() <= 1e-6, (fn, sign * bp, steps.max())


# ---------------------------------------------------------------------------
# K2: fused cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("b,d,hidden", [(4, 6, 20), (33, 16, 32), (32, 48, 48)])
def test_lstm_cell_matches_jax(impl, b, d, hidden):
    w, u, bias = _weights(0, d, hidden)
    x, h, c = _x(0, b, d), _x(1, b, hidden), _x(2, b, hidden)
    want_h, want_c = j_lstm_cell(*_j((x, h, c, w, u, bias)), impl=impl, block_b=32,
                                 interpret=True)
    got_h, got_c = t_lstm_cell(*_t((x, h, c, w, u, bias)), impl=impl, block_b=32)
    assert_parity(got_h, want_h, impl, 2e-5, "h")
    assert_parity(got_c, want_c, impl, 2e-5, "c")
    # and against the port's own oracle (semantics with torch.tanh)
    ref_h, ref_c = tref.lstm_cell_ref(*_t((x, h, c, w, u, bias)), impl=impl)
    assert_parity(got_h, ref_h.numpy(), impl, 2e-5, "h vs oracle")
    assert_parity(got_c, ref_c.numpy(), impl, 2e-5, "c vs oracle")


@pytest.mark.parametrize("impl", IMPLS)
def test_lstm_cell_ref_matches_jax(impl):
    w, u, bias = _weights(1, 6, 20)
    x, h, c = _x(0, 5, 6), _x(1, 5, 20), _x(2, 5, 20)
    want_h, want_c = jref.lstm_cell_ref(*_j((x, h, c, w, u, bias)), impl=impl)
    got_h, got_c = tref.lstm_cell_ref(*_t((x, h, c, w, u, bias)), impl=impl)
    assert_parity(got_h, want_h, impl, 2e-5)
    assert_parity(got_c, want_c, impl, 2e-5)


# ---------------------------------------------------------------------------
# K3: sequence kernel, f32 and int8
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("b,s,d,hidden,block_b", [
    (4, 7, 6, 20, 4),      # block divides batch, odd seq
    (5, 9, 6, 20, 2),      # block_b does not divide B
    (33, 12, 16, 32, 16),  # ragged batch
])
def test_lstm_seq_matches_jax(impl, b, s, d, hidden, block_b):
    w, u, bias = _weights(2, d, hidden)
    x = _x(3, b, s, d)
    want_hs, (want_hn, want_cn) = jseq.lstm_seq_fused(
        *_j((x, w, u, bias)), impl=impl, block_b=block_b, interpret=True, return_state=True)
    got_hs, (got_hn, got_cn) = tseq.lstm_seq_fused(
        *_t((x, w, u, bias)), impl=impl, block_b=block_b, return_state=True)
    near = _near(impl, x, [(w, u, bias)])
    assert_parity(got_hs, want_hs, impl, 2e-5, "hs", near)
    assert_parity(got_hn, want_hn, impl, 2e-5, "hn", near)
    assert_parity(got_cn, want_cn, impl, 2e-5, "cn", near)
    assert torch.equal(got_hs[:, -1], got_hn)
    only_hs = tseq.lstm_seq_fused(*_t((x, w, u, bias)), impl=impl, block_b="auto")
    assert torch.equal(only_hs, got_hs)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("b,s,d,hidden,block_b", [(4, 7, 6, 20, 4), (5, 9, 6, 20, 2)])
def test_lstm_seq_quantized_matches_jax(impl, b, s, d, hidden, block_b):
    w, u, bias = _weights(3, d, hidden)
    x = _x(4, b, s, d)
    jqw = jq.quantize_lstm_weights(*_j((w, u, bias)), hidden)
    tqw = tq.quantize_lstm_weights(*_t((w, u, bias)), hidden)
    want_hs, (want_hn, want_cn) = jseq.lstm_seq_fused_quantized(
        jnp.asarray(x), jqw, impl=impl, block_b=block_b, interpret=True, return_state=True)
    got_hs, (got_hn, got_cn) = tseq.lstm_seq_fused_quantized(
        torch.from_numpy(x), tqw, impl=impl, block_b=block_b, return_state=True)
    near = _near(impl, x, [_q(tqw)], packed=True)
    assert_parity(got_hs, want_hs, impl, 1e-4, "hs", near)
    assert_parity(got_hn, want_hn, impl, 1e-4, "hn", near)
    assert_parity(got_cn, want_cn, impl, 1e-4, "cn", near)
    # the quantized oracle on both sides
    ref_hs, ref_h, ref_c = tref.lstm_seq_q8_ref(
        torch.from_numpy(x), tqw.w_q, tqw.u_q, tqw.b, tqw.w_scale, tqw.u_scale, impl=impl)
    jref_hs, _, _ = jref.lstm_seq_q8_ref(
        jnp.asarray(x), jqw.w_q, jqw.u_q, jqw.b, jqw.w_scale, jqw.u_scale, impl=impl)
    assert_parity(ref_hs, jref_hs, impl, 1e-4, "oracle vs oracle", near)
    assert_parity(got_hs, ref_hs.numpy(), impl, 1e-4, "kernel vs oracle", near)
    assert_parity(got_cn, ref_c.numpy(), impl, 1e-4, "cn vs oracle", near)


@pytest.mark.parametrize("impl", ["exact", "hard"])
def test_lstm_seq_q8_on_the_fly_matches_jax(impl):
    w, u, bias = _weights(4, 12, 24)
    x = _x(5, 8, 10, 12)
    want = jseq.lstm_seq_fused_q8(*_j((x, w, u, bias)), impl=impl, block_b=4, interpret=True)
    got = tseq.lstm_seq_fused_q8(*_t((x, w, u, bias)), impl=impl, block_b=4)
    assert_parity(got, want, impl, 1e-4)
    f32 = tseq.lstm_seq_fused(*_t((x, w, u, bias)), impl=impl, block_b=4)
    assert float((got - f32).abs().max()) < 0.05  # int8 weight rounding stays small


# ---------------------------------------------------------------------------
# K4: layer-fused stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("layers", [1, 3])
def test_lstm_stack_matches_jax(impl, quantized, layers):
    b, s, d, hidden, block_b = 5, 9, 6, 20, 2
    ws = _weights(5, d, hidden, layers=layers)
    x = _x(6, b, s, d)
    want_hs, (want_hn, want_cn) = jseq.lstm_stack_fused(
        jnp.asarray(x), [_j(l) for l in ws], impl=impl, block_b=block_b, quantized=quantized,
        interpret=True, return_state=True)
    got_hs, (got_hn, got_cn) = tseq.lstm_stack_fused(
        torch.from_numpy(x), [_t(l) for l in ws], impl=impl, block_b=block_b,
        quantized=quantized, return_state=True)
    tol = 1e-4 if quantized else 2e-5
    assert got_hn.shape == (layers, b, hidden) and got_cn.shape == (layers, b, hidden)
    near = _near(impl, x, [_q(tq.quantize_lstm_weights(*_t(l))) for l in ws] if quantized
                 else ws, packed=quantized)
    assert_parity(got_hs, want_hs, impl, tol, "hs", near)
    assert_parity(got_hn, want_hn, impl, tol, "hn", near, axis=1)
    assert_parity(got_cn, want_cn, impl, tol, "cn", near, axis=1)


def test_lstm_stack_takes_param_dicts_and_equals_sequential():
    ws = _weights(6, 6, 20, layers=2)
    x = torch.from_numpy(_x(7, 4, 7, 6))
    dicts = [dict(zip("wub", _t(l))) for l in ws]
    got = tseq.lstm_stack_fused(x, dicts, block_b=4)
    h = x
    for l in dicts:
        h = tseq.lstm_seq_fused(h, l["w"], l["u"], l["b"], block_b=4)
    np.testing.assert_allclose(got.numpy(), h.numpy(), atol=2e-5, rtol=2e-5)


def test_lstm_stack_rejects_bad_layers():
    x = torch.zeros(2, 3, 6)
    w, u, b = _t(_weights(7, 6, 20))
    with pytest.raises(ValueError):
        tseq.lstm_stack_fused(x, [])
    with pytest.raises(ValueError):
        tseq.lstm_stack_fused(x, [(w, u, b), (w, u, b)])  # layer 1 must be (H, 4H)


# ---------------------------------------------------------------------------
# Wrapper contracts that the CPU can check
# ---------------------------------------------------------------------------
def test_kernels_take_f32_only():
    w, u, b = _t(_weights(8, 6, 20))
    x = torch.zeros(2, 3, 6)
    with pytest.raises(TypeError):
        tseq.lstm_seq_fused(x.to(torch.bfloat16), w, u, b)
    with pytest.raises(TypeError):
        tseq.lstm_seq_fused(x, w.to(torch.bfloat16), u, b)
    with pytest.raises(TypeError):
        t_lstm_cell(x[:, 0].double(), torch.zeros(2, 20), torch.zeros(2, 20), w, u, b)
    with pytest.raises(ValueError):
        tseq.lstm_seq_fused(x, w, u, b, impl="cubic")
    with pytest.raises(ValueError):
        tseq.lstm_seq_fused(x, w, u, b, block_b=0)
    with pytest.raises(ValueError):
        tseq.lstm_seq_fused(x, w[:, :-4], u, b)


@pytest.mark.parametrize("batch,want", [(1, 1), (64, 1), (132, 1), (133, 2), (300, 4), (5000, 4)])
def test_auto_block_rule(batch, want):
    """"auto" at the paper's widths is the block-size tuner's pick on the
    block path; ``want`` is the tile of the fixed rule it replaced (the
    smallest power of two up to 4 within one block an SM), which the tuner's
    model never predicts faster than its own pick."""
    from repro_torch.kernels import autotune

    problem = {"batch": batch, "seq": 28, "d_in": 6, "hidden": 20}
    plan = tseq.plan_launch("auto", batch, 28, 6, 20)
    assert plan.path == "block" and plan.block_b <= batch
    assert autotune.predict_time_s("lstm_seq", problem, {"block_b": plan.block_b}) <= \
        autotune.predict_time_s("lstm_seq", problem, {"block_b": want})


def test_block_b_is_honoured_or_refused():
    assert runtime.pick_block_b(16, 33, lambda bb: 0, "k") == 16
    assert runtime.pick_block_b(64, 33, lambda bb: 0, "k") == 33
    with pytest.raises(ValueError, match="shared memory"):
        runtime.pick_block_b(8, 33, lambda bb: runtime.MAX_SHARED_BYTES + 1, "k")
    # "auto" is resolved by the tuner before a tile reaches pick_block_b
    with pytest.raises(ValueError, match="tuner"):
        runtime.pick_block_b("auto", 5000, lambda bb: 60000 * bb, "k")


def test_launch_plan_residency():
    """Where the weights live: in one block's shared memory at the paper's
    shape and the small bench widths; at D = H = 256 (f32 and int8) u's
    slices stay in the shared memory of a cluster's blocks, for one layer
    and for a stack alike (the same plan)."""
    paper = tseq.plan_launch("auto", 64, 28, 6, 20)
    assert paper.resident and paper.block_b == 1 and paper.path == "block"
    assert paper.cluster == 1 and paper.clusters == 64
    scaled = tseq.plan_launch("auto", 32, 64, 16, 32)
    assert scaled.resident and scaled.path == "block"
    for quantized in (False, True):
        big = tseq.plan_launch("auto", 40, 28, 256, 256, quantized=quantized)
        assert big.resident and big.path == "cluster" and big.cluster > 1
        assert big.smem_bytes <= runtime.MAX_SHARED_BYTES
        stack = tseq.plan_launch("auto", 40, 28, 256, 256, layers=3, quantized=quantized)
        assert stack.resident and stack.path == "cluster" and stack.cluster == tseq.CLUSTER
        assert stack == big and stack.smem_bytes <= runtime.MAX_SHARED_BYTES
    # the plan's bytes are the layout's bytes
    assert paper.smem_bytes == tseq.seq_smem_bytes(1, 28, 6, 20, 1, 4, True)
    assert cell_smem_bytes(2, 6, 20) == 4 * (256 + 52 + 26 * 36 + 2 * 32)


# ---------------------------------------------------------------------------
# K3's cluster path: the plan (CPU) and its arithmetic against JAX
# ---------------------------------------------------------------------------
def _cu_constant(name):
    text = (ROOT / "src" / "repro_torch" / "csrc" / "lstm_seq.cu").read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, name
    return int(found.group(1))


def test_cluster_constants_are_the_kernels():
    assert tseq.CLUSTER == _cu_constant("kCluster")
    assert tseq.CLUSTER_THREADS == _cu_constant("kClusterThreads")
    assert tseq.PROJ_ROWS == _cu_constant("kProjRows")
    assert tseq.PROJ_K == _cu_constant("kProjK")
    assert tseq.BARRIER_BYTES == _cu_constant("kBarrierBytes")


H100_SLOTS = 15  # clusters of 8 an H100 SXM holds at once, one block an SM (chip_smoke.py)


@pytest.mark.parametrize("quantized", [False, True])
def test_cluster_plan_at_the_bench_width(quantized):
    """D = H = 256, 40 rows: a cluster path whose shared memory fits a block,
    holds the whole input projection, and counts as the C side does:
    table | two h buffers | c | scratch | zx | u slice."""
    plan = tseq.plan_launch("auto", 40, 28, 256, 256, quantized=quantized, slots=H100_SLOTS)
    assert plan.path == "cluster" and plan.chunk == 28 and plan.cluster == tseq.CLUSTER == 8
    assert plan.block_b == 3 and plan.clusters == 14 <= H100_SLOTS
    bb, hc, lanes = plan.block_b, 256 // 8, 8  # 256 threads over H / C column quads
    wbytes = 1 if quantized else 4
    stage = lanes * 12 * 16 + 16 * 4 * hc * wbytes // 4  # x rows, then w rows
    floats = (256 + 2 * bb * 256 + bb * hc + max(lanes * bb * 4 * hc, 2 * stage)
              + 28 * bb * 4 * hc)
    assert plan.smem_bytes == 16 + 4 * floats + 256 * 4 * hc * wbytes
    assert plan.smem_bytes <= runtime.MAX_SHARED_BYTES
    assert tseq.cluster_smem_bytes(5, 28, 256, wbytes) == (
        16 + 4 * (256 + 2 * 5 * 256 + 5 * hc + max(lanes * 5 * 4 * hc, 2 * stage)
                  + 28 * 5 * 4 * hc)
        + 256 * 4 * hc * wbytes)


@pytest.mark.parametrize("slots,want_bb", [(15, 3), (30, 2), (None, 3), (1, 40)])
def test_cluster_plan_spreads_the_batch_over_the_slots(slots, want_bb):
    """"auto" gives each of the card's cluster slots a share of the batch,
    so that all clusters run in one wave (None: the tuner's chip model, 15
    slots).  With one slot the clusters run one after another: 40 rows in
    one cluster do not fit a block, 14 (3 clusters) fit with a projection of
    one step at a time, and the tuner takes 10 rows (4 clusters, 7 steps
    projected at a time), whose re-staged projection costs less."""
    plan = tseq.plan_launch("auto", 40, 28, 256, 256, slots=slots)
    if want_bb == 40:
        assert tseq.cluster_smem_bytes(40, 1, 256, 4) > runtime.MAX_SHARED_BYTES
        assert plan.path == "cluster" and plan.block_b == 10 and plan.clusters == 4
        assert plan.chunk == 7
        return
    assert plan.path == "cluster" and plan.block_b == want_bb
    assert plan.clusters == -(-40 // want_bb) <= (slots or runtime.SM_COUNT // tseq.CLUSTER)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("block_b", [5, 6, 7])
def test_cluster_plan_honours_block_b(quantized, block_b):
    """An int block_b is the rows of one cluster; 6 and 7 leave a ragged
    last cluster."""
    plan = tseq.plan_launch(block_b, 40, 28, 256, 256, quantized=quantized)
    assert plan.path == "cluster" and plan.block_b == block_b
    assert plan.clusters == -(-40 // block_b) and plan.cluster == tseq.CLUSTER
    assert plan.smem_bytes <= runtime.MAX_SHARED_BYTES


def test_cluster_plan_refusals():
    # 40 rows in one cluster: its h buffers and partial sums alone are over a
    # block's shared memory, and so are 40 rows of the L2 path
    with pytest.raises(ValueError, match="shared memory"):
        tseq.plan_launch(40, 40, 28, 256, 256)
    for bad in (0, -2, 2.5, True, "8"):
        with pytest.raises(ValueError, match="block_b"):
            tseq.plan_launch(bad, 8, 28, 256, 256)


def test_cluster_plan_chunks_a_long_sequence():
    """When zx for the whole sequence does not fit beside u's slice, the
    projection runs a chunk of steps at a time."""
    plan = tseq.plan_launch("auto", 40, 1000, 256, 256)
    assert plan.path == "cluster" and 1 <= plan.chunk < 1000
    assert plan.smem_bytes <= runtime.MAX_SHARED_BYTES
    assert tseq.cluster_smem_bytes(plan.block_b, plan.chunk + 1, 256, 4) > \
        runtime.MAX_SHARED_BYTES


@pytest.mark.parametrize("quantized,want_chunk", [(False, 1), (True, 15)])
def test_cluster_plan_chunks_a_large_batch(quantized, want_chunk):
    """The chunked case chip_smoke.py runs on the card: 200 rows over 15
    clusters, 14 rows a cluster (the tile it passes, the plan the tuner
    replaced), leave room for 1 step of zx in f32 and 15 in int8 (two
    chunks, the second of 13 steps)."""
    plan = tseq.plan_launch(14, 200, 28, 256, 256, quantized=quantized, slots=H100_SLOTS)
    assert plan.path == "cluster" and plan.block_b == 14 and plan.clusters == 15
    assert plan.chunk == want_chunk
    wbytes = 1 if quantized else 4
    assert plan.smem_bytes == tseq.cluster_smem_bytes(14, want_chunk, 256, wbytes)
    assert tseq.cluster_smem_bytes(14, want_chunk + 1, 256, wbytes) > runtime.MAX_SHARED_BYTES


@pytest.mark.parametrize("quantized", [False, True])
def test_l2_path_beyond_the_cluster(quantized):
    """H = 1024: even a cluster's slice of u (2 MB f32, 512 KB int8) does
    not fit a block, so the weights are re-read from L2 each step."""
    plan = tseq.plan_launch("auto", 40, 28, 256, 1024, quantized=quantized)
    assert plan.path == "l2" and not plan.resident and plan.cluster == 1
    assert plan.smem_bytes <= runtime.MAX_SHARED_BYTES


def test_l2_path_where_the_units_do_not_split():
    """H = 200 neither fits a block nor splits into whole quads over 8
    blocks, for one layer or a stack; at H = 256 a stack takes the cluster
    path as one layer does."""
    assert not tseq.cluster_shape_ok(200) and tseq.cluster_shape_ok(256)
    assert tseq.plan_launch("auto", 40, 28, 200, 200).path == "l2"
    assert tseq.plan_launch("auto", 40, 28, 200, 200, layers=2).path == "l2"
    assert tseq.plan_launch("auto", 40, 28, 256, 256, layers=2).path == "cluster"
    assert tseq.plan_launch("auto", 64, 28, 6, 20).path == "block"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("b,s,d,block_b", [
    (5, 9, 12, 2),     # ragged last cluster
    (4, 6, 20, "auto"),
])
def test_lstm_seq_cluster_shape_matches_jax(impl, b, s, d, block_b):
    """At H = 256 the plan sends f32 and int8 weights to the cluster path
    (the weights do not fit one block); on the CPU the wrappers run the
    plain version, so this holds the plan's choice and the plain version's
    arithmetic at that shape to the JAX kernel in interpret mode.  The
    cluster kernel itself runs only on the card (chip_smoke.py)."""
    hidden = 256
    for quantized in (False, True):
        plan = tseq.plan_launch(block_b, b, s, d, hidden, quantized=quantized)
        assert plan.path == "cluster" and plan.cluster == tseq.CLUSTER
    w, u, bias = _weights(10, d, hidden)
    x = _x(11, b, s, d)
    jb = b if block_b == "auto" else block_b
    want_hs, (want_hn, want_cn) = jseq.lstm_seq_fused(
        *_j((x, w, u, bias)), impl=impl, block_b=jb, interpret=True, return_state=True)
    got_hs, (got_hn, got_cn) = tseq.lstm_seq_fused(
        *_t((x, w, u, bias)), impl=impl, block_b=block_b, return_state=True)
    near = _near(impl, x, [(w, u, bias)])
    assert_parity(got_hs, want_hs, impl, 2e-5, "hs", near)
    assert_parity(got_hn, want_hn, impl, 2e-5, "hn", near)
    assert_parity(got_cn, want_cn, impl, 2e-5, "cn", near)

    jqw = jq.quantize_lstm_weights(*_j((w, u, bias)), hidden)
    tqw = tq.quantize_lstm_weights(*_t((w, u, bias)), hidden)
    want_q, (_, want_qc) = jseq.lstm_seq_fused_quantized(
        jnp.asarray(x), jqw, impl=impl, block_b=jb, interpret=True, return_state=True)
    got_q, (_, got_qc) = tseq.lstm_seq_fused_quantized(
        torch.from_numpy(x), tqw, impl=impl, block_b=block_b, return_state=True)
    near = _near(impl, x, [_q(tqw)], packed=True)
    assert_parity(got_q, want_q, impl, 1e-4, "hs int8", near)
    assert_parity(got_qc, want_qc, impl, 1e-4, "cn int8", near)


def test_stack_takes_the_cluster_path_where_one_row_does_not_fit_a_block():
    """S·H·4 bytes of inter-layer sequence for one row (300 x 256 x 4 =
    307,200) are over a block's shared memory, which the block and L2 paths
    need; the cluster path keeps that sequence in device memory and
    projects it `chunk` < S steps at a time."""
    plan = tseq.plan_launch("auto", 1, 300, 4, 256, layers=2)
    assert plan.path == "cluster" and plan.block_b == 1 and 1 <= plan.chunk < 300
    assert plan.smem_bytes == tseq.cluster_smem_bytes(1, plan.chunk, 256, 4)
    assert tseq.cluster_smem_bytes(1, plan.chunk + 1, 256, 4) > runtime.MAX_SHARED_BYTES
    ws = _weights(9, 4, 256, layers=2)
    x = torch.from_numpy(_x(12, 1, 300, 4))
    got = tseq.lstm_stack_fused(x, [_t(l) for l in ws])
    h = x
    for l in ws:
        h = tseq.lstm_seq_fused(h, *_t(l))
    np.testing.assert_allclose(got.numpy(), h.numpy(), atol=2e-5, rtol=2e-5)


def test_stack_raises_where_it_cannot_run():
    """H = 200 does not split over a cluster, and one row's inter-layer
    sequence (300 x 200 x 4 = 240,000 bytes) is over a block's shared
    memory: the stack is refused, with the bound."""
    ws = _weights(9, 4, 200, layers=2)
    x = torch.zeros(1, 300, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tseq.lstm_stack_fused(x, [_t(l) for l in ws])


# ---------------------------------------------------------------------------
# K4 on the cluster path: the plan (CPU) and its arithmetic against JAX
# ---------------------------------------------------------------------------
STACK_SHAPE = (40, 28, 256, 256, 3)  # chip_smoke.py's stack


@pytest.mark.parametrize("quantized", [False, True])
def test_stack_cluster_plan_at_the_bench_width(quantized):
    """"auto" at the stack's bench shape gives K3's plan: 3 rows a cluster,
    14 clusters, the whole projection of each layer at once."""
    b, s, d, hidden, layers = STACK_SHAPE
    plan = tseq.plan_launch("auto", b, s, d, hidden, layers=layers, quantized=quantized,
                            slots=H100_SLOTS)
    assert plan == tseq.plan_launch("auto", b, s, d, hidden, quantized=quantized,
                                    slots=H100_SLOTS)
    assert plan.path == "cluster" and plan.block_b == 3 and plan.clusters == 14
    assert plan.chunk == s and plan.cluster == tseq.CLUSTER
    assert plan.smem_bytes == tseq.cluster_smem_bytes(3, s, hidden, 1 if quantized else 4)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("block_b,clusters,last", [(3, 14, 1), (5, 8, 5), (7, 6, 5)])
def test_stack_cluster_plan_honours_block_b(quantized, block_b, clusters, last):
    """An int block_b is the rows of one cluster, for every layer; 3 and 7
    leave a ragged last cluster."""
    b, s, d, hidden, layers = STACK_SHAPE
    plan = tseq.plan_launch(block_b, b, s, d, hidden, layers=layers, quantized=quantized)
    assert plan.path == "cluster" and plan.block_b == block_b and plan.clusters == clusters
    assert b - (clusters - 1) * block_b == last
    assert plan.smem_bytes <= runtime.MAX_SHARED_BYTES


@pytest.mark.parametrize("quantized,want_chunk", [(False, 1), (True, 15)])
def test_stack_cluster_plan_chunks_a_large_batch(quantized, want_chunk):
    """The chunked stack chip_smoke.py runs: (200, 28, 256, 256, 3) at 14
    rows a cluster plans 15 clusters, each layer's projection 1 step (f32)
    or 15 (int8) at a time."""
    plan = tseq.plan_launch(14, 200, 28, 256, 256, layers=3, quantized=quantized,
                            slots=H100_SLOTS)
    assert plan.path == "cluster" and plan.block_b == 14 and plan.clusters == 15
    assert plan.chunk == want_chunk < 28


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layers", [2, 3])
def test_lstm_stack_cluster_shape_matches_jax(impl, layers):
    """At H = 256 the plan sends a stack, f32 and int8, to the cluster path;
    on the CPU the wrapper runs the plain version, so this holds the plan's
    choice and the plain version's arithmetic at that shape to the JAX stack
    kernel in interpret mode.  The cluster kernel itself runs only on the
    card (chip_smoke.py)."""
    b, s, d, hidden = 3, 5, 12, 256
    # weights at std 1/sqrt(fan-in), as models are initialised: at
    # _weights' fixed 0.3 the pre-activations at this width have std ~5, the
    # gates saturate, and three layers carry the two sides' f32 summation
    # orders to ~2.3e-5 in a cell state (impl="hard")
    ws = [tuple((a * (1.0 / (0.3 * np.sqrt(a.shape[0]))) if a.ndim == 2 else a).astype(np.float32)
                for a in l) for l in _weights(13, d, hidden, layers=layers)]
    x = _x(14, b, s, d)
    for quantized in (False, True):
        plan = tseq.plan_launch("auto", b, s, d, hidden, layers=layers, quantized=quantized)
        assert plan.path == "cluster" and plan.cluster == tseq.CLUSTER
        want_hs, (want_hn, want_cn) = jseq.lstm_stack_fused(
            jnp.asarray(x), [_j(l) for l in ws], impl=impl, block_b=b, quantized=quantized,
            interpret=True, return_state=True)
        got_hs, (got_hn, got_cn) = tseq.lstm_stack_fused(
            torch.from_numpy(x), [_t(l) for l in ws], impl=impl, quantized=quantized,
            return_state=True)
        tol = 1e-4 if quantized else 2e-5
        assert got_hn.shape == (layers, b, hidden)
        near = _near(impl, x, [_q(tq.quantize_lstm_weights(*_t(l))) for l in ws] if quantized
                     else ws, packed=quantized)
        assert_parity(got_hs, want_hs, impl, tol, f"hs q={quantized}", near)
        assert_parity(got_hn, want_hn, impl, tol, f"hn q={quantized}", near, axis=1)
        assert_parity(got_cn, want_cn, impl, tol, f"cn q={quantized}", near, axis=1)


# ---------------------------------------------------------------------------
# K2's geometry (CPU)
# ---------------------------------------------------------------------------
def _cu_text(name):
    return (ROOT / "src" / "repro_torch" / "csrc" / name).read_text()


def test_cell_constants_are_the_kernels():
    text = _cu_text("lstm_cell.cu")
    assert re.search(rf"constexpr int kCellUnits = {cell_mod.UNITS};", text)
    assert re.search(r"constexpr int kCellStride = 4 \* kCellUnits \+ 4;", text)
    assert cell_mod.ROW_STRIDE == 4 * cell_mod.UNITS + 4


@pytest.mark.parametrize("batch,d,hidden,rows,grid", [
    (40, 256, 256, 10, (4, 32)),   # K2's main path: one wave of 128 blocks
    (64, 6, 20, 2, (32, 3)),       # the paper's shape: 20 units in 3 groups, the last of 4
    (33, 6, 20, 1, (33, 3)),
    (32, 16, 32, 1, (32, 4)),
    (1, 64, 1024, 1, (1, 128)),
    (300, 48, 48, 14, (22, 6)),
])
def test_cell_plan_auto(batch, d, hidden, rows, grid):
    plan = cell_mod.plan("auto", batch, d, hidden)
    assert (plan.units, plan.rows, plan.grid) == (cell_mod.UNITS, rows, grid)
    assert plan.grid[0] * plan.grid[1] <= max(runtime.SM_COUNT, plan.grid[1])
    assert plan.smem_bytes == cell_smem_bytes(rows, d, hidden) <= runtime.MAX_SHARED_BYTES


@pytest.mark.parametrize("block_b", ["auto", 1, 5, 7, 40, 64])
@pytest.mark.parametrize("batch,d,hidden", [(40, 256, 256), (64, 6, 20), (33, 6, 20),
                                            (9, 12, 13)])
def test_cell_plan_covers_every_output_once(block_b, batch, d, hidden):
    """Every (row, gate column) of the (B, 4H) pre-activations belongs to
    exactly one block: row tile rt holds rows [rt rows, (rt + 1) rows), unit
    group ug the units [8 ug, 8 ug + 8) and their columns j, H+j, 2H+j, 3H+j."""
    plan = cell_mod.plan(block_b, batch, d, hidden)
    seen = np.zeros((batch, 4 * hidden), dtype=np.int64)
    for rt in range(plan.grid[0]):
        for ug in range(plan.grid[1]):
            rows = slice(rt * plan.rows, min((rt + 1) * plan.rows, batch))
            for j in range(ug * plan.units, min((ug + 1) * plan.units, hidden)):
                for gate in range(4):
                    seen[rows, gate * hidden + j] += 1
    assert (seen == 1).all()
    if block_b != "auto":
        assert plan.rows == min(block_b, batch)


def test_cell_plan_refusals():
    # 200 rows of [x | h] at D = H = 256: 400 KB, over a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        cell_mod.plan(200, 300, 256, 256)
    for bad in (0, -1, 2.5, True, "4"):
        with pytest.raises(ValueError, match="block_b"):
            cell_mod.plan(bad, 8, 6, 20)
    with pytest.raises(ValueError, match="shared memory"):  # the wrapper refuses as the plan
        t_lstm_cell(*_t((_x(0, 300, 256), _x(1, 300, 256), _x(2, 300, 256),
                         *_weights(0, 256, 256))), block_b=200)
    # "auto" stays within a block's shared memory where the batch is too
    # large for one wave, and runs no more waves than the widest tile that fits
    plan = cell_mod.plan("auto", 4000, 256, 256)
    widest = max(r for r in range(1, 4001)
                 if cell_smem_bytes(r, 256, 256) <= runtime.MAX_SHARED_BYTES)
    blocks = lambda rows: -(-4000 // rows) * plan.grid[1]  # noqa: E731
    assert plan.smem_bytes <= runtime.MAX_SHARED_BYTES and plan.rows <= widest
    assert -(-blocks(plan.rows) // runtime.SM_COUNT) == -(-blocks(widest) // runtime.SM_COUNT)


# ---------------------------------------------------------------------------
# The C entry points read as many arguments as runtime.ENTRY_ARGS says
# ---------------------------------------------------------------------------
def test_entry_args_are_the_entry_points():
    found = {}
    for path in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"):
        for name, count in re.findall(
                r'extern "C" int (\w+)\(const long long\* a, int count\) \{\s*'
                r'using namespace repro;\s*if \(count != (\d+)\)', path.read_text()):
            found[name] = int(count)
    assert found == runtime.ENTRY_ARGS
