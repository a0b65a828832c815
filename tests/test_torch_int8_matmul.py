"""K5 ``int8_matmul`` in the port: its plain version, the ops wrappers and
``models/quant.py`` against the JAX package, bit for bit.

The int32 sum is exact and the epilogue runs in one order, ``(acc·sx)·sw``,
so every comparison here is bit-identical (``assert_array_equal`` on the
f32 bits), not a tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro.models import quant as jquant
from repro.models.model import init_model as jax_init_model
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.kernels import ops, runtime
from repro_torch.kernels import ref as tref
from repro_torch.kernels.int8_matmul import (
    BLOCK_K, MAX_K, STAGES, int8_matmul, int8_matmul_plain, plan,
)
from repro_torch.models import quant as tquant
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)

DENSE = ("granite-3-8b", "granite-34b", "starcoder2-15b", "qwen1.5-110b")


def _same_bits(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_array_equal(got, want)


def _operands(seed: int, m: int, k: int, n: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    xq, sx = jref.quantize_rowwise(jnp.asarray(x))
    wq, sw = jref.quantize_colwise(jnp.asarray(w))
    return [np.array(a) for a in (xq, wq, sx, sw)]


# the reference's kernel-test shapes, a ragged one, and a long ragged K
@pytest.mark.parametrize("m,k,n", [(64, 128, 64), (128, 256, 128), (32, 64, 96), (5, 37, 19),
                                   (3, 4100, 7)])
def test_plain_version_is_bit_identical_to_jax(m, k, n):
    xq, wq, sx, sw = _operands(m * 7 + n, m, k, n)
    want_ref = jref.int8_matmul_ref(*map(jnp.asarray, (xq, wq, sx, sw)))
    targs = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    got = int8_matmul_plain(*targs)
    _same_bits(got, want_ref)
    _same_bits(tref.int8_matmul_ref(*targs), want_ref)
    if m % 32 == 0 and n % 32 == 0 and k % 32 == 0:  # the Pallas kernel does not pad
        want_kernel = jax_int8_matmul(*map(jnp.asarray, (xq, wq, sx, sw)), block_m=32,
                                      block_n=32, block_k=32, interpret=True)
        _same_bits(got, want_kernel)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    xq, wq, sx, sw = (torch.from_numpy(a) for a in _operands(1, 6, 40, 10))
    runtime.reset_launch_counts()
    got = int8_matmul(xq, wq, sx, sw)
    assert runtime.launch_counts() == {}
    _same_bits(got, int8_matmul_plain(xq, wq, sx, sw).numpy())
    _same_bits(ops.int8_matmul(xq, wq, sx, sw), got.numpy())


@pytest.mark.parametrize("bad", ["dtype", "scale_shape", "inner", "rank", "k_too_long"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    xq, wq, sx, sw = (torch.from_numpy(a) for a in _operands(2, 4, 8, 4))
    if bad == "k_too_long":  # the int32 sums could overflow
        with pytest.raises(ValueError, match="overflow"):
            int8_matmul(torch.ones((1, MAX_K + 1), dtype=torch.int8),
                        torch.ones((MAX_K + 1, 1), dtype=torch.int8),
                        torch.ones((1, 1)), torch.ones(1))
    elif bad == "dtype":
        with pytest.raises(TypeError):
            int8_matmul(xq.to(torch.int32), wq, sx, sw)
    elif bad == "scale_shape":
        with pytest.raises(ValueError):
            int8_matmul(xq, wq, sx[:, 0], sw)
    elif bad == "inner":
        with pytest.raises(ValueError):
            int8_matmul(xq, wq[:4], sx, sw)
    else:
        with pytest.raises(ValueError):
            int8_matmul(xq[None], wq, sx, sw)


# Every projection of granite-3-8b's serving path (wq/wo, wk/wv, wg/wu, wd) at
# decode (M = 4 slots), a 64-token slot prefill and a 4 x 64-token prefill,
# then ragged shapes.
PROJ_KN = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096)]
PATH_SHAPES = [(m, k, n) for m in (4, 64, 256) for k, n in PROJ_KN]
RAGGED_SHAPES = [(4, 12803, 1030), (33, 4100, 1030), (5, 37, 19), (3, 4100, 7), (1, 1, 1),
                 (17, 65, 129), (16, 64 * 300 + 1, 64), (300, 4096, 100)]


@pytest.mark.parametrize("m,k,n", PATH_SHAPES + RAGGED_SHAPES)
def test_plan_covers_k_and_fills_the_card(m, k, n):
    p = plan(m, k, n)
    assert (p.block_m, p.block_n) in ((16, 64), (16, 128), (64, 128), (128, 128))
    assert p.block_m >= min(m, 16) and (m <= 16) == (p.block_m == 16)
    # the chunks cover K exactly: none empty, none past the end, multiples of 32
    assert p.k_chunk % BLOCK_K == 0 and p.k_chunk % 32 == 0 and p.k_chunk > 0
    assert (p.split_k - 1) * p.k_chunk < k <= p.split_k * p.k_chunk
    assert 1 <= p.split_k <= 65535
    # no int32 sum of a chunk or of the whole row can overflow
    assert k <= MAX_K and 128 * 128 * k <= 2**31 - 1
    if (m, k, n) in PATH_SHAPES and m <= 16:
        # decode: two blocks an SM at least, unless the chunks are already as
        # short as the tuner takes them (one cp.async ring of STAGES stages)
        assert p.blocks(m, n) >= 2 * runtime.SM_COUNT or p.k_chunk == STAGES * BLOCK_K
    if (m, k, n) in PATH_SHAPES:
        # the tuner's model never predicts its pick slower than the fixed rule
        # it replaced, where that rule's chunk is one the tuner takes
        from repro_torch.kernels import autotune

        problem = {"m": m, "k": k, "n": n}
        rule = _fixed_rule(m, k, n)
        if rule.k_chunk in autotune.k_chunks(k):
            assert autotune.predict_time_s("int8_matmul", problem, _fields(p), dtype="int8") \
                <= autotune.predict_time_s("int8_matmul", problem, _fields(rule), dtype="int8")


def _fields(p):
    return {"block_m": p.block_m, "block_n": p.block_n, "block_k": p.k_chunk}


def _fixed_rule(m, k, n):
    """The geometry ``plan`` took before the block-size tuner: 16-row tiles
    at decode, K split until the grid holds 2 x 132 blocks; 64- or 128-row
    tiles above, K split while the tiles leave SMs idle, chunks of 8 stages
    at least."""
    if m <= 16:
        block_m, target, min_steps = 16, 2 * runtime.SM_COUNT, 1
        block_n = 128 if n >= 4096 else 64
    elif m <= 64:
        block_m, block_n, target, min_steps = 64, 128, runtime.SM_COUNT, 8
    else:
        block_m, block_n, target, min_steps = 128, 128, runtime.SM_COUNT, 8
    steps = -(-k // BLOCK_K)
    tiles = -(-m // block_m) * -(-n // block_n)
    per = max(steps // -(-target // tiles), min(min_steps, steps), 1)
    return plan(m, k, n, block_m, block_n, per * BLOCK_K)


def _split_k_emulation(xq, wq, sx, sw, order):
    """What the kernel does with ``plan``'s chunks: int32 partial sums per
    chunk, added in ``order``, then the epilogue (acc·sx)·sw in f32."""
    m, k = xq.shape
    p = plan(m, k, wq.shape[1])
    parts = [torch.matmul(xq[:, c * p.k_chunk:(c + 1) * p.k_chunk].to(torch.int64),
                          wq[c * p.k_chunk:(c + 1) * p.k_chunk].to(torch.int64))
             for c in range(p.split_k)]
    acc = torch.zeros_like(parts[0])
    for c in order(p.split_k):
        assert int(parts[c].abs().max()) < 2**31
        acc += parts[c]
        assert int(acc.abs().max()) < 2**31  # every prefix fits the int32 workspace
    return p, acc.to(torch.int32).to(torch.float32) * sx * sw[None, :]


@pytest.mark.parametrize("m,k,n", [(4, 4096, 1024), (4, 12803, 1030), (33, 4100, 1030),
                                   (64, 4096, 1024), (256, 4096, 1024), (4, 12800, 256)])
def test_split_k_emulation_is_bit_identical_to_plain_and_jax(m, k, n):
    xq, wq, sx, sw = _operands(m + k + n, m, k, n)
    targs = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    want = jref.int8_matmul_ref(*map(jnp.asarray, (xq, wq, sx, sw)))
    rng = np.random.default_rng(k)
    orders = (lambda s: range(s), lambda s: reversed(range(s)),
              lambda s: rng.permutation(s).tolist())
    for order in orders:
        p, got = _split_k_emulation(*targs, order)
        _same_bits(got, want)
        _same_bits(got, int8_matmul_plain(*targs).numpy())
    assert p.split_k > 1  # every case here is split


def test_block_sizes_other_than_auto_are_refused():
    """A built tile and any chunk of K that is a multiple of BLOCK_K are
    honoured, with the plain version's bits (the int32 sum is exact); a tile
    or chunk the kernel is not built for raises a ValueError naming what is."""
    xq, wq, sx, sw = (torch.from_numpy(a) for a in _operands(3, 4, 200, 40))
    want = int8_matmul_plain(xq, wq, sx, sw)
    for bm, bn, bk in ((16, 64, 64), (64, 128, 128), (128, 128, 256), (16, 128, "auto")):
        _same_bits(ops.int8_matmul(xq, wq, sx, sw, block_m=bm, block_n=bn, block_k=bk),
                   want.numpy())
        p = plan(4, 200, 40, bm, bn, bk)
        assert (p.block_m, p.block_n) == (bm, bn)
        assert bk == "auto" or p.k_chunk == min(bk, 256) and p.split_k == -(-200 // p.k_chunk)
    with pytest.raises(ValueError, match=r"built \(block_m, block_n\)"):
        ops.int8_matmul(xq, wq, sx, sw, block_m=32)
    with pytest.raises(ValueError, match=r"built \(block_m, block_n\)"):
        ops.int8_matmul(xq, wq, sx, sw, block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.int8_matmul(xq, wq, sx, sw, block_m=16, block_n=64, block_k=96)


def test_quantized_matmul_matches_jax_and_bounds_error():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    got = ops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w))
    xq, sx = jref.quantize_rowwise(jnp.asarray(x))
    wq, sw = jref.quantize_colwise(jnp.asarray(w))
    _same_bits(got, jref.int8_matmul_ref(xq, wq, sx, sw))
    rel = float(np.linalg.norm(got.numpy() - x @ w) / np.linalg.norm(x @ w))
    assert rel < 0.02, rel


# ---------------------------------------------------------------------------
# qeinsum: passthrough, fast path (with and without a batch label), fallback
# ---------------------------------------------------------------------------
def _qt_pair(w: np.ndarray, lead: int, n_contract: int):
    jq = jquant._quantize_weight(jnp.asarray(w), lead=lead, n_contract=n_contract)
    tq = tquant.quantize_weight(torch.from_numpy(w), lead=lead, n_contract=n_contract)
    _same_bits(tq.q, jq.q)
    _same_bits(tq.scale, jq.scale)
    return jq, tq


@pytest.mark.parametrize("spec,xshape,wshape,lead,nc", [
    ("bsd,dhe->bshe", (2, 5, 16), (16, 4, 8), 0, 1),     # q/k/v projection
    ("bshe,hed->bsd", (2, 5, 4, 8), (4, 8, 16), 0, 2),   # attention output, two contract axes
    ("bsf,fd->bsd", (3, 1, 24), (24, 16), 0, 1),         # MLP down, decode shape
    ("ecd,edf->ecf", (3, 6, 16), (3, 16, 8), 1, 1),      # batch label (the MoE expert axis)
])
def test_qeinsum_fast_path_bit_identical(spec, xshape, wshape, lead, nc):
    rng = np.random.default_rng(len(spec) + sum(xshape))
    x = rng.standard_normal(xshape).astype(np.float32)
    w = rng.standard_normal(wshape).astype(np.float32)
    jq, tq = _qt_pair(w, lead, nc)
    want = jquant.qeinsum(spec, jnp.asarray(x), jq)
    _same_bits(tquant.qeinsum(spec, torch.from_numpy(x), tq), want)


def test_qeinsum_passthrough_is_einsum():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4, 8)).astype(np.float32)
    got = tquant.qeinsum("bsd,dhe->bshe", torch.from_numpy(x), torch.from_numpy(w))
    want = jquant.qeinsum("bsd,dhe->bshe", jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, torch.einsum("bsd,dhe->bshe", torch.from_numpy(x),
                                         torch.from_numpy(w)))


def test_qeinsum_fallback_uses_dequantized_weights():
    """A spec that does not collapse to a column-scaled product (MLA's
    absorbed decode) computes with exactly ``dequantize(w)``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 3, 8)).astype(np.float32)
    w = rng.standard_normal((6, 3, 8)).astype(np.float32)
    jq, tq = _qt_pair(w, 0, 1)
    _same_bits(tquant.dequantize(tq), jquant.dequantize(jq))
    got = tquant.qeinsum("bqhe,rhe->bqhr", torch.from_numpy(x), tq)
    want = jquant.qeinsum("bqhe,rhe->bqhr", jnp.asarray(x), jq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, torch.einsum("bqhe,rhe->bqhr", torch.from_numpy(x),
                                         tquant.dequantize(tq)))


def test_qeinsum_runs_the_int8_matmul_once_per_call_on_the_cpu_version(monkeypatch):
    """Every fast-path call goes through ``int8_matmul`` whatever the shape
    (no multiple-of-128 rule); on CPU tensors that is the plain version."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 3, 10)).astype(np.float32))
    w = rng.standard_normal((10, 6)).astype(np.float32)
    _, tq = _qt_pair(w, 0, 1)
    calls = []
    real = tquant.int8_matmul
    monkeypatch.setattr(tquant, "int8_matmul", lambda *a: calls.append(a[0].shape) or real(*a))
    tquant.qeinsum("bsd,df->bsf", x, tq)
    assert calls == [torch.Size([3, 10])]


# ---------------------------------------------------------------------------
# quantize_params: byte for byte, per dense config; idempotent
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_quantize_params_byte_identical(arch):
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_config(arch), dtype=torch.float32)
    jp = jax_init_model(jcfg, jax.random.PRNGKey(0))
    want = jquant.quantize_params(jp, jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tquant.quantize_params(tp, tcfg)
    is_q = lambda l: isinstance(l, jquant.QuantTensor)  # noqa: E731
    want_leaves = jax.tree.leaves(want, is_leaf=is_q)
    got_leaves = []

    def collect(t):
        if isinstance(t, dict):
            for key in sorted(t):  # jax flattens dicts in sorted key order
                collect(t[key])
        else:
            got_leaves.append(t)

    collect(got)
    assert len(got_leaves) == len(want_leaves)
    n_quant = 0
    for g, w in zip(got_leaves, want_leaves):
        assert isinstance(g, tquant.QuantTensor) == is_q(w)
        if is_q(w):
            n_quant += 1
            _same_bits(g.q, w.q)
            _same_bits(g.scale, w.scale)
    assert n_quant == (6 if tcfg.activation == "gelu" else 7)
    again = tquant.quantize_params(got, tcfg)
    assert again["blocks"]["attn"]["wq"] is got["blocks"]["attn"]["wq"]


# ---------------------------------------------------------------------------
# params_from_numpy: bf16 bit for bit, QuantTensor leaves
# ---------------------------------------------------------------------------
def test_params_from_numpy_carries_bf16_bit_for_bit():
    a = jnp.asarray(np.random.default_rng(7).standard_normal((5, 3)), jnp.bfloat16)
    tree = {"w": np.asarray(a), "ones": np.asarray(jnp.ones((2, 3), jnp.bfloat16))}
    got = params_from_numpy(tree, "cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
    assert torch.equal(got["ones"], torch.ones((2, 3), dtype=torch.bfloat16))


def test_params_from_numpy_carries_quant_tensors():
    w = np.random.default_rng(8).standard_normal((2, 16, 4, 8)).astype(np.float32)
    jq = jquant._quantize_weight(jnp.asarray(w), lead=1, n_contract=1)
    got = params_from_numpy({"blocks": {"wq": jax.tree.map(np.asarray, jq)}}, "cpu")
    tq = got["blocks"]["wq"]
    assert isinstance(tq, tquant.QuantTensor)
    _same_bits(tq.q, jq.q)
    _same_bits(tq.scale, jq.scale)
