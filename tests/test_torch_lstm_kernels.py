"""Cross-framework parity of the LSTM kernel modules: the same numpy inputs
and weights through the JAX functions (Pallas in interpret mode) and through
the port's wrappers (on the CPU: the kernels' plain PyTorch versions).

Tolerances are those of ``tests/test_kernels.py``: 2e-5 for f32, 1e-4 for
int8 weights.  ``impl="lut"`` is the one discontinuous variant: a
pre-activation that differs in its last bits between two summation orders
can land in the neighbouring table bin (one table step, up to ~8e-3 on a
sigmoid) and feed the next time step.  Its rule has two parts: at most 0.1%
of the elements above the tolerance, none above 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lstm_quant as jq
from repro.kernels import lstm_seq as jseq
from repro.kernels import ref as jref
from repro.kernels.lstm_cell import lstm_cell_fused as j_lstm_cell
from repro_torch.kernels import lstm_quant as tq
from repro_torch.kernels import lstm_seq as tseq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import runtime
from repro_torch.kernels.lstm_cell import cell_smem_bytes
from repro_torch.kernels.lstm_cell import lstm_cell_fused as t_lstm_cell

torch.set_num_threads(1)

IMPLS = ["exact", "pwl", "lut", "hard"]


def assert_parity(got, want, impl, tol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if impl != "lut":
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


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


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
    assert_parity(got_hs, want_hs, impl, 2e-5, "hs")
    assert_parity(got_hn, want_hn, impl, 2e-5, "hn")
    assert_parity(got_cn, want_cn, impl, 2e-5, "cn")
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
    assert_parity(got_hs, want_hs, impl, 1e-4, "hs")
    assert_parity(got_hn, want_hn, impl, 1e-4, "hn")
    assert_parity(got_cn, want_cn, impl, 1e-4, "cn")
    # the quantized oracle on both sides
    ref_hs, ref_h, ref_c = tref.lstm_seq_q8_ref(
        torch.from_numpy(x), tqw.w_q, tqw.u_q, tqw.b, tqw.w_scale, tqw.u_scale, impl=impl)
    jref_hs, _, _ = jref.lstm_seq_q8_ref(
        jnp.asarray(x), jqw.w_q, jqw.u_q, jqw.b, jqw.w_scale, jqw.u_scale, impl=impl)
    assert_parity(ref_hs, jref_hs, impl, 1e-4, "oracle vs oracle")
    assert_parity(got_hs, ref_hs.numpy(), impl, 1e-4, "kernel vs oracle")
    assert_parity(got_cn, ref_c.numpy(), impl, 1e-4, "cn vs oracle")


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
    assert_parity(got_hs, want_hs, impl, tol, "hs")
    assert_parity(got_hn, want_hn, impl, tol, "hn")
    assert_parity(got_cn, want_cn, impl, tol, "cn")


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
    assert runtime.pick_block_b("auto", batch, lambda bb: 1024 * bb, "k") == want


def test_block_b_is_honoured_or_refused():
    assert runtime.pick_block_b(16, 33, lambda bb: 0, "k") == 16
    assert runtime.pick_block_b(64, 33, lambda bb: 0, "k") == 33
    with pytest.raises(ValueError, match="shared memory"):
        runtime.pick_block_b(8, 33, lambda bb: runtime.MAX_SHARED_BYTES + 1, "k")
    # "auto" halves the tile until it fits
    assert runtime.pick_block_b("auto", 5000, lambda bb: 60000 * bb, "k") == 2


def test_launch_plan_residency():
    """Where the weights live: in shared memory at the paper's shape and the
    small bench widths, re-read each step at D = H = 256 (f32 and int8)."""
    paper = tseq.plan_launch("auto", 64, 28, 6, 20)
    assert paper.resident and paper.block_b == 1
    assert tseq.plan_launch("auto", 32, 64, 16, 32).resident
    for quantized in (False, True):
        big = tseq.plan_launch("auto", 40, 28, 256, 256, quantized=quantized)
        assert not big.resident and big.smem_bytes <= runtime.MAX_SHARED_BYTES
        stack = tseq.plan_launch("auto", 40, 28, 256, 256, layers=3, quantized=quantized)
        assert not stack.resident and stack.smem_bytes <= runtime.MAX_SHARED_BYTES
    # the plan's bytes are the layout's bytes
    assert paper.smem_bytes == tseq.seq_smem_bytes(1, 28, 6, 20, 1, 4, True)
    assert cell_smem_bytes(2, 6, 20) == 4 * (256 + 12 + 40 + 4 * 160)


def test_stack_raises_when_one_row_does_not_fit():
    """S·H·4 bytes of inter-layer sequence per batch row must fit a block."""
    ws = _weights(9, 4, 256, layers=2)
    x = torch.zeros(1, 300, 4)  # 300 * 256 * 4 = 307,200 bytes > 232,448
    with pytest.raises(ValueError, match="shared memory"):
        tseq.lstm_stack_fused(x, [_t(l) for l in ws])
