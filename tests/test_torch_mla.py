"""The port's MLA attention against the JAX package, in f32 on the CPU at
deepseek-v3-reduced: the prefill form (``mla_apply``: K/V decompressed per
head, q/k of width nope + rope against v of its own width), the absorbed
decode form at per-row positions (JAX's, which takes one scalar position,
called row by row) and the absorbed chunk form, with the compressed cache
rows written where they belong.  Outputs and caches agree to 1e-5 of their
largest magnitude; with int8 weights to the int8 rule of
``test_torch_chunked_prefill``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import layers as jlayers
from repro.models import quant as jquant
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.models import layers as tlayers
from repro_torch.models.params import params_from_numpy

from test_torch_chunked_prefill import close_q8
from test_torch_moe import close, jax_quantize_weight, numpy_params

torch.set_num_threads(1)
ARCH, SMAX = "deepseek-v3-671b", 12
# the reference's functions under jax.jit, the config static (one compile a
# shape, where op by op compiles every operation)
mla_apply = jax.jit(jlayers.mla_apply, static_argnums=2)
mla_ckv = jax.jit(jlayers._mla_ckv, static_argnums=2)
mla_decode_apply = jax.jit(jlayers.mla_decode_apply, static_argnums=5)
mla_chunk_apply = jax.jit(jlayers.mla_chunk_apply, static_argnums=5)


def setup(quant: bool = False, seed: int = 0):
    jcfg = dataclasses.replace(jax_config(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_config(ARCH), dtype=torch.float32)
    jp = numpy_params(jlayers.mla_defs(jcfg), np.random.default_rng(seed))
    if quant:
        jp = {k: jax_quantize_weight(v, lead=0, n_contract=2 if k == "wo" else 1)
              if k in jquant.QUANT_KEYS else v for k, v in jp.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def agree(got, want, quant):
    (close_q8 if quant else close)(got, want)


def caches(cfg, b: int, seed: int):
    """A compressed cache with random rows (stale data where nothing was
    written: the masks must hide it)."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return (rng.standard_normal((b, SMAX, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((b, SMAX, m.qk_rope_head_dim)).astype(np.float32))


@pytest.mark.parametrize("quant", [False, True])
def test_mla_apply_matches_jax(quant):
    jcfg, tcfg, jp, tp = setup(quant)
    x = np.random.default_rng(1).standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    want = mla_apply(jp, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got = tlayers.mla_apply(tp, torch.from_numpy(x), tcfg)
        out, (c, krope) = tlayers.mla_prefill_attn(tp, torch.from_numpy(x), tcfg)
    agree(got, want, quant)
    assert torch.equal(out, got)
    jc, jr = mla_ckv(jp, jnp.asarray(x), jcfg, jnp.arange(7)[None, :])
    agree(c, jc, quant)
    agree(krope, jr, quant)


@pytest.mark.parametrize("quant", [False, True])
def test_mla_decode_at_per_row_positions_matches_jax_row_by_row(quant):
    """Three rows at positions 0, 5 and 11 (the last row of the cache) in
    one call; JAX decodes each row alone at its scalar position."""
    jcfg, tcfg, jp, tp = setup(quant, seed=2)
    pos = np.asarray([0, 5, SMAX - 1])
    x = np.random.default_rng(3).standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    c0, r0 = caches(jcfg, 3, 4)
    tc, tr = torch.from_numpy(c0.copy()), torch.from_numpy(r0.copy())
    with torch.inference_mode():
        out, tc2, tr2 = tlayers.mla_decode_apply(tp, torch.from_numpy(x), tc, tr,
                                                 torch.from_numpy(pos), tcfg)
    assert tc2 is tc and tr2 is tr  # written in place
    for b, p in enumerate(pos):
        jo, jc, jr = mla_decode_apply(jp, jnp.asarray(x[b:b + 1]),
                                              jnp.asarray(c0[b:b + 1]),
                                              jnp.asarray(r0[b:b + 1]), int(p), jcfg)
        agree(out[b:b + 1], jo, quant)
        agree(tc[b:b + 1], jc, quant)
        agree(tr[b:b + 1], jr, quant)
        # exactly one row written, at the row's own position
        others = np.arange(SMAX) != p
        np.testing.assert_array_equal(tc[b, others].numpy(), c0[b, others])
        np.testing.assert_array_equal(tr[b, others].numpy(), r0[b, others])
        assert not np.array_equal(tc[b, p].numpy(), c0[b, p])


@pytest.mark.parametrize("quant", [False, True])
def test_mla_chunk_matches_jax_and_writes_its_span(quant):
    """Chunks of 4 tokens at positions 2 and 6 per row (JAX row by row);
    the span [pos, pos + 4) is written, nothing else."""
    jcfg, tcfg, jp, tp = setup(quant, seed=5)
    pos, t = np.asarray([2, 6]), 4
    x = np.random.default_rng(6).standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    c0, r0 = caches(jcfg, 2, 7)
    tc, tr = torch.from_numpy(c0.copy()), torch.from_numpy(r0.copy())
    with torch.inference_mode():
        out, _, _ = tlayers.mla_chunk_apply(tp, torch.from_numpy(x), tc, tr,
                                            torch.from_numpy(pos), tcfg)
    for b, p in enumerate(pos):
        jo, jc, jr = mla_chunk_apply(jp, jnp.asarray(x[b:b + 1]),
                                             jnp.asarray(c0[b:b + 1]),
                                             jnp.asarray(r0[b:b + 1]), int(p), jcfg)
        agree(out[b:b + 1], jo, quant)
        agree(tc[b:b + 1], jc, quant)
        agree(tr[b:b + 1], jr, quant)
        outside = (np.arange(SMAX) < p) | (np.arange(SMAX) >= p + t)
        np.testing.assert_array_equal(tc[b, outside].numpy(), c0[b, outside])


def test_mla_chunk_of_one_token_is_the_decode_step():
    """The chunk form at T = 1 is the decode form: the same numerical path."""
    jcfg, tcfg, jp, tp = setup(seed=8)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 1, jcfg.d_model)).astype(
        np.float32))
    pos = torch.as_tensor([3, 7])
    c0, r0 = caches(jcfg, 2, 10)
    a = [torch.from_numpy(c0.copy()), torch.from_numpy(r0.copy())]
    b = [torch.from_numpy(c0.copy()), torch.from_numpy(r0.copy())]
    with torch.inference_mode():
        od = tlayers.mla_decode_apply(tp, x, *a, pos, tcfg)[0]
        oc = tlayers.mla_chunk_apply(tp, x, *b, pos, tcfg)[0]
    assert torch.equal(od, oc)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
