"""K6 ``flash_attention`` in the port: its plain version and its oracle
against the JAX package's kernel (interpret mode) and oracle, at the JAX
kernel tests' shapes and tolerances (2e-5 in f32: both sum the products in
another order; 3e-2 in bf16: the output is rounded to bf16), and the f32
kernel's split-TF32 arithmetic, emulated here, against the same reference."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.core.energy import DEFAULT_CHIP
from repro_torch.kernels import ops, runtime
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, NEG_INF, ROW_PAD_QK_F32, ROW_PAD_V_F32, TILE_K, flash_attention,
    flash_attention_plain, flash_smem_bytes,
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
    assert flash_smem_bytes(d, "bfloat16") <= runtime.MAX_SHARED_BYTES
    assert 3 * flash_smem_bytes(d, "bfloat16") <= runtime.MAX_SHARED_BYTES
    assert ((d + 8) * 2) % 16 == 0


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_shared_memory_fits_one_block(d):
    """The f32 kernel's q tile and two stages of key and value tiles fit the
    227 KB one block may use, two blocks an SM (each SM keeps 1 KB a block);
    its padded rows keep cp.async's 16-byte alignment, and their pitches (8
    and 4 mod 16 floats) put a half warp's 8-byte q and k fragment loads and
    a warp's v loads (rows 2t and 2t + 1, column g) in distinct banks."""
    smem = flash_smem_bytes(d, "float32")
    assert smem <= runtime.MAX_SHARED_BYTES
    assert 2 * (smem + 1024) <= DEFAULT_CHIP.smem_per_sm
    qk, vv = d + ROW_PAD_QK_F32, d + ROW_PAD_V_F32
    assert (qk * 4) % 16 == 0 and (vv * 4) % 16 == 0
    for half in (range(16), range(16, 32)):
        words = [(g * qk + 2 * t + w) % 32 for g, t in (divmod(l, 4) for l in half) for w in (0, 1)]
        assert len(set(words)) == 32
    for row in (0, 1):
        banks = [((2 * t + row) * vv + g) % 32 for g, t in (divmod(l, 4) for l in range(32))]
        assert len(set(banks)) == 32
    with pytest.raises(TypeError):
        flash_smem_bytes(d, "float16")


# ---------------------------------------------------------------------------
# The f32 kernel's split-TF32 arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits'
    unit to the bit pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_product(eq: str, a, b, terms: str = "3xtf32"):
    """``einsum(eq, a, b)`` as the kernel forms it: a = a_hi + a_lo and
    b = b_hi + b_lo, each part rounded to TF32, summed as a_lo b_hi +
    a_hi b_lo + a_hi b_hi in f32 (lo·lo dropped).  ``terms="hi"`` keeps only
    a_hi b_hi: TF32 without the split."""
    a_hi, b_hi = rna_tf32(a), rna_tf32(b)
    big = torch.einsum(eq, a_hi, b_hi)
    if terms == "hi":
        return big
    a_lo, b_lo = rna_tf32(a - a_hi), rna_tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)) + big


def emulate_f32_kernel(q, k, v, *, causal: bool, terms: str = "3xtf32"):
    """The f32 kernel's arithmetic tile by tile at ``TILE_K``: both products
    split (p too, kept in f32 like the reference), scores scaled and masked
    at -1e30, the online softmax in f32, then acc / max(l, 1e-37)."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, k.shape[2], TILE_K):
        kt = k[:, :, k0:k0 + TILE_K].repeat_interleave(g, dim=1)
        vt = v[:, :, k0:k0 + TILE_K].repeat_interleave(g, dim=1)
        s = split_product("bhqd,bhkd->bhqk", q, kt, terms) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + split_product("bhqk,bhkd->bhqd", p, vt, terms)
        m = m_new
    return acc / torch.clamp_min(l, 1e-37)


def test_rna_tf32_rounds_to_nearest_ties_away():
    """Ten mantissa bits kept: 1 + 2^-11 is a tie (rounds up, away from
    zero, on both signs), just under it rounds down, and the result's low 13
    bits are clear."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 3 * ulp / 2,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0], dtype=torch.float32)
    got = rna_tf32(x)
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


# the reference's shapes, and long D = 128 rows: 2048 keys a row without a
# mask, and with the top-left causal mask rows that see 1 to 64 keys
SPLIT_SHAPES = SHAPES + [(1, 2, 1, 64, 2048, 128, False), (1, 2, 1, 64, 2048, 128, True)]


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal", SPLIT_SHAPES)
def test_split_tf32_emulation_holds_the_f32_tolerance(b, h, kv, sq, sk, d, causal):
    """The split-TF32 design holds 2e-5 against the JAX kernel (interpret
    mode), as the plain version does, before any kernel runs on a card."""
    q, k, v = _qkv(sq + d + sk, b, h, kv, sq, sk, d)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=64,
                                block_k=64, interpret=True))
    got = emulate_f32_kernel(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_tf32_without_the_split_fails_the_f32_tolerance():
    """The negative control: the hi·hi term alone (TF32 products) misses
    2e-5 at D = 128, by an order of magnitude, where the split holds it."""
    b, h, kv, sq, sk, d, causal = SPLIT_SHAPES[-1]
    q, k, v = _qkv(sq + d + sk, b, h, kv, sq, sk, d)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    split = np.abs(emulate_f32_kernel(tq, tk, tv, causal=causal).numpy() - want).max()
    hi_only = np.abs(emulate_f32_kernel(tq, tk, tv, causal=causal, terms="hi").numpy()
                     - want).max()
    assert split < 2e-5 < hi_only / 10


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
