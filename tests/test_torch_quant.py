"""The port's quantizers must be byte-identical to the JAX package's: same
int8 payloads and the same bits in the f32 scales, on inputs that include
exact .5 ties and an all-zero column."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lstm_quant as jq
from repro.kernels import ref as jref
from repro.kernels.lstm_seq import _pack_ifog as j_pack
from repro_torch.kernels import lstm_quant as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels.lstm_seq import _pack_ifog as t_pack

torch.set_num_threads(1)


def _same_bits(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_array_equal(got, want)


def _matrix(seed: int, shape):
    """Random f32 matrix with planted exact ties and an all-zero column."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.7).astype(np.float32)
    rows, cols = shape
    if rows >= 6 and cols >= 6:
        # Column 1 and row 2 get amax 127 → scale exactly 1, so x.5 values are
        # exact ties of round(x / scale): half-to-even must decide them.
        x[:, 1] = 0.0
        x[:6, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
        x[2, :] = 0.0
        x[2, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
        x[:, 3] = 0.0   # all-zero column: scale clamps at 1e-8 / 127
        x[2, 3] = 0.0
    return x


@pytest.mark.parametrize("seed,shape", [(0, (16, 24)), (1, (33, 80)), (2, (4, 5)), (3, (128, 192))])
def test_quantize_rowwise_byte_identical(seed, shape):
    x = _matrix(seed, shape)
    want_q, want_s = jref.quantize_rowwise(jnp.asarray(x))
    got_q, got_s = tref.quantize_rowwise(torch.from_numpy(x))
    assert got_q.dtype == torch.int8
    _same_bits(got_q, want_q)
    _same_bits(got_s, want_s)


@pytest.mark.parametrize("seed,shape", [(0, (16, 24)), (1, (33, 80)), (2, (4, 5)), (3, (128, 192))])
def test_quantize_colwise_byte_identical(seed, shape):
    x = _matrix(seed, shape)
    want_q, want_s = jref.quantize_colwise(jnp.asarray(x))
    got_q, got_s = tref.quantize_colwise(torch.from_numpy(x))
    assert got_q.dtype == torch.int8
    _same_bits(got_q, want_q)
    _same_bits(got_s, want_s)


def test_ties_round_half_to_even():
    x = _matrix(0, (16, 24))
    q, s = tref.quantize_colwise(torch.from_numpy(x))
    assert float(s[1]) == 1.0
    # row 2 of the matrix was overwritten after column 1: its entry is 0.5
    assert q[:6, 1].tolist() == [127, 0, 0, 2, 0, -4]
    qr, sr = tref.quantize_rowwise(torch.from_numpy(x))
    assert float(sr[2, 0]) == 1.0
    assert qr[2, :6].tolist() == [127, 0, 2, 0, 0, -4]   # 0.5→0, 1.5→2, column 3 zeroed
    assert float(s[3]) == np.float32(1e-8) / np.float32(127.0) and int(q[:, 3].abs().max()) == 0


def _lstm_weights(seed: int, d: int, hidden: int):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, 4 * hidden)) * 0.3).astype(np.float32)
    u = (rng.standard_normal((hidden, 4 * hidden)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((4 * hidden,)) * 0.1).astype(np.float32)
    w[:, 2] = 0.0  # an all-zero gate column
    return w, u, b


def _same_quantized(got: tq.QuantizedLSTMWeights, want: jq.QuantizedLSTMWeights):
    for name in ("w_q", "u_q", "b", "w_scale", "u_scale"):
        _same_bits(getattr(got, name), getattr(want, name))
    assert got.hidden == want.hidden


@pytest.mark.parametrize("seed,d,hidden", [(0, 6, 20), (1, 16, 32), (2, 48, 48)])
def test_quantize_lstm_weights_byte_identical(seed, d, hidden):
    w, u, b = _lstm_weights(seed, d, hidden)
    want = jq.quantize_lstm_weights(jnp.asarray(w), jnp.asarray(u), jnp.asarray(b), hidden)
    got = tq.quantize_lstm_weights(*(torch.from_numpy(a) for a in (w, u, b)), hidden)
    _same_quantized(got, want)
    # dequantize gives the same f32 values on both sides
    for g, j in zip(tq.dequantize(got), jq.dequantize(want)):
        _same_bits(g, j)


@pytest.mark.parametrize("as_dicts", [False, True])
def test_quantize_lstm_stack_byte_identical(as_dicts):
    layers = [_lstm_weights(s, 6 if s == 0 else 20, 20) for s in range(3)]
    if as_dicts:
        jl = [dict(zip("wub", map(jnp.asarray, l))) for l in layers]
        tl = [dict(zip("wub", map(torch.from_numpy, l))) for l in layers]
    else:
        jl = [tuple(map(jnp.asarray, l)) for l in layers]
        tl = [tuple(map(torch.from_numpy, l)) for l in layers]
    want = jq.quantize_lstm_stack(jl)
    got = tq.quantize_lstm_stack(tl)
    assert len(got) == len(want) == 3
    for g, j in zip(got, want):
        _same_quantized(g, j)


def test_pack_ifog_order_by_value():
    """Gate columns i,f,g,o → i,f,o,g, checked on columns tagged by gate."""
    hidden = 5
    tags = np.repeat(np.arange(4, dtype=np.float32), hidden)  # i=0 f=1 g=2 o=3
    w = np.tile(tags, (3, 1))
    u = np.tile(tags, (hidden, 1)) + 10
    b = tags + 20
    tw, tu, tb = t_pack(torch.from_numpy(w), torch.from_numpy(u), torch.from_numpy(b), hidden)
    want = np.repeat(np.array([0, 1, 3, 2], np.float32), hidden)
    np.testing.assert_array_equal(tw.numpy()[0], want)
    np.testing.assert_array_equal(tu.numpy()[0], want + 10)
    np.testing.assert_array_equal(tb.numpy(), want + 20)
    for got, ref in zip((tw, tu, tb), j_pack(jnp.asarray(w), jnp.asarray(u), jnp.asarray(b), hidden)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantized_weights_are_packed_once():
    """``QuantizedLSTMWeights`` is stored packed: its bias is the packed bias
    and its payload dequantizes to the packed weights."""
    w, u, b = _lstm_weights(4, 6, 20)
    q = tq.quantize_lstm_weights(*(torch.from_numpy(a) for a in (w, u, b)))
    pw, pu, pb = t_pack(*(torch.from_numpy(a) for a in (w, u, b)), 20)
    np.testing.assert_array_equal(q.b.numpy(), pb.numpy())
    dw, du, _ = tq.dequantize(q)
    assert float((dw - pw).abs().max()) <= float(q.w_scale.max()) * 0.5 + 1e-7
    assert float((du - pu).abs().max()) <= float(q.u_scale.max()) * 0.5 + 1e-7


@pytest.mark.parametrize("d,hidden,dtype", [(6, 20, "float32"), (256, 256, "float32"),
                                             (256, 256, "int8"), (16, 32, "int8")])
def test_resident_weight_bytes_matches_jax(d, hidden, dtype):
    assert tq.resident_weight_bytes(d, hidden, dtype) == jq.resident_weight_bytes(d, hidden, dtype)
