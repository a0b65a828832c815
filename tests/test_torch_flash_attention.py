"""K6 ``flash_attention`` in the port: its plain version and its oracle
against the JAX package's kernel (interpret mode) and oracle, at the JAX
kernel tests' shapes and tolerances (2e-5 in f32: both sum the products in
another order; 3e-2 in bf16: the output is rounded to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops, runtime
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, flash_attention, flash_attention_plain, flash_smem_bytes,
)

torch.set_num_threads(1)

SHAPES = [  # b, h, kv, sq, sk, d, causal (tests/test_kernels.py)
    (1, 4, 4, 128, 128, 32, True),
    (2, 8, 2, 128, 128, 64, True),    # GQA 4:1
    (1, 4, 1, 64, 256, 32, False),    # MQA, cross-shaped
    (2, 2, 2, 256, 256, 16, True),
]


def _qkv(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", SHAPES)
def test_plain_version_matches_jax(b, h, kv, sq, sk, d, causal):
    q, k, v = _qkv(sq + d, b, h, kv, sq, sk, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                                interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tref.flash_attention_ref(tq, tk, tv, causal=causal).numpy(),
                               np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
                               atol=2e-5, rtol=2e-5)


# bf16: the reference's four shapes, the first bf16 case (GQA 2:1), and the
# granite head width (D = 128, GQA 4:1, causal, Sq < Sk).  The plain version
# rounds p to bf16 before p @ v, as the bf16 kernel does; the JAX kernel keeps
# p in f32.  Both outputs are rounded to bf16, hence the reference's 3e-2.
BF16_SHAPES = SHAPES + [(1, 4, 2, 128, 128, 32, True), (1, 8, 2, 64, 128, 128, True)]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", BF16_SHAPES)
def test_plain_version_bf16(b, h, kv, sq, sk, d, causal):
    q, k, v = _qkv(9 + d, b, h, kv, sq, sk, d)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                                interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


def test_plain_version_bf16_rounds_p_like_the_kernel():
    """For bf16 inputs the plain version sums p @ v over p rounded to bf16
    (the kernel's A operand), with l summed over p before the rounding; on
    one tile of keys that is this computation, and it differs from the one
    that keeps p in f32."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(21, 1, 1, 1, 8, 40, 16))
    s_ = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * 0.25
    p = torch.exp(s_ - s_.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)

    def out(pv):
        return (torch.einsum("bhqk,bhkd->bhqd", pv, v.float()) / l).to(torch.bfloat16)

    got = flash_attention_plain(q, k, v, causal=False)
    assert torch.equal(got, out(p.to(torch.bfloat16).float()))
    assert not torch.equal(got, out(p))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bf16_shared_memory_fits_one_block(d):
    """The bf16 kernel's two stages of key and value tiles fit the 227 KB one
    block may use (three blocks an SM at every head width), and the padded
    rows keep ldmatrix's 16-byte alignment."""
    assert flash_smem_bytes(d) <= runtime.MAX_SHARED_BYTES
    assert 3 * flash_smem_bytes(d) <= runtime.MAX_SHARED_BYTES
    assert ((d + 8) * 2) % 16 == 0


def test_ragged_lengths_are_masked_not_refused():
    """The kernel's tiles need not divide Sq or Sk (the TPU kernel asserts
    they do); the plain version, which shares the kernel's tiles, agrees
    with the whole-row softmax there."""
    q, k, v = _qkv(11, 1, 6, 3, 45, 77, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for causal in (True, False):
        np.testing.assert_allclose(flash_attention_plain(tq, tk, tv, causal=causal).numpy(),
                                   tref.flash_attention_ref(tq, tk, tv, causal=causal).numpy(),
                                   atol=2e-5, rtol=2e-5)


def test_a_row_scored_at_the_mask_constant_averages_its_values():
    """A row whose every score is the mask constant -1e30 (what a fully
    masked row sees) gets uniform weights, as the reference's -1e30 and
    max(l, 1e-37) give, not zeros."""
    q = torch.zeros(1, 1, 1, 16)
    k = torch.zeros(1, 1, 40, 16)
    v = torch.arange(40 * 16, dtype=torch.float32).reshape(1, 1, 40, 16)
    q[..., 0] = -4e30  # score = -4e30 * 1 / sqrt(16) = -1e30 in f32
    k[..., 0] = 1.0
    got = flash_attention_plain(q, k, v, causal=False)
    np.testing.assert_allclose(got[0, 0, 0].numpy(), v[0, 0].mean(0).numpy(), rtol=1e-6)


def test_wrapper_on_cpu_and_ops():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 4, 2, 40, 40, 32))
    runtime.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    assert runtime.launch_counts() == {}
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True))
    # the built tile is honoured, with the plain version's bits; any other
    # raises a ValueError naming the built tiles
    built = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=32)
    assert torch.equal(built, got)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    assert torch.equal(ops.flash_attention(*bf, causal=True, block_q=64, block_k=64),
                       flash_attention_plain(*bf, causal=True))
    with pytest.raises(ValueError, match="built"):
        ops.flash_attention(q, k, v, block_q=128)
    with pytest.raises(ValueError, match="built"):
        ops.flash_attention(*bf, block_q=64, block_k=32)


@pytest.mark.parametrize("bad", ["heads", "dtype", "shape"])
def test_wrapper_refuses_bad_arguments(bad):
    q, k, v = map(torch.from_numpy, _qkv(4, 1, 4, 2, 8, 8, 16))
    if bad == "heads":
        with pytest.raises(ValueError):
            flash_attention(q, k[:, :1].expand(1, 3, 8, 16).contiguous(),
                            v[:, :1].expand(1, 3, 8, 16).contiguous())
    elif bad == "dtype":
        with pytest.raises(TypeError):
            flash_attention(q, k.double(), v)
    else:
        with pytest.raises(ValueError):
            flash_attention(q, k[..., :8], v[..., :8])
