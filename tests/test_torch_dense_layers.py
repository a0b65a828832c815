"""The port's dense-family layers against the JAX package's, in f32 at
reduced widths, on the same numpy inputs and weights.

Tolerance 1e-5 relative, and 1e-5 of the largest magnitude absolute, unless
stated: the two frameworks sum products and reduce means in other orders,
which moves the last bits of f32 results (the projections here reach
magnitudes of 20: the reference's fan-in rule takes the head count as the
fan-in of wq); a wrong cast, mask or axis moves them by far more."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import layers as jl
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.models import layers as tl
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)
TOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    assert tuple(got.shape) == tuple(np.shape(want)), (got.shape, np.shape(want))
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=tol)


def _configs(arch: str):
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_config(arch), dtype=torch.float32)
    return jcfg, tcfg


def test_norms():
    x = _rand(0, 2, 5, 64, scale=3.0)
    scale, bias = _rand(1, 64), _rand(2, 64)
    _close(tl.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    p = {"scale": scale, "bias": bias}
    _close(tl.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)),
           jl.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [10_000.0, 100_000.0, 1_000_000.0])
def test_rope(theta):
    x = _rand(3, 2, 7, 4, 16)
    pos = np.random.default_rng(4).integers(0, 300, (2, 7))
    _close(tl.rope_frequencies(16, theta), jl.rope_frequencies(16, theta), tol=1e-7)
    # positions up to 300: the angles are ~300 rad, where one ulp of f32 is 3e-5
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), tol=1e-4)


@pytest.mark.parametrize("h,kv,causal", [(4, 2, True), (4, 1, False), (4, 4, True)])
def test_attention_naive_and_chunked(h, kv, causal):
    q, k, v = _rand(5, 2, 64, h, 16), _rand(6, 2, 64, kv, 16), _rand(7, 2, 64, kv, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(tl.attention_naive(tq, tk, tv, causal=causal),
           jl.attention_naive(jq, jk, jv, causal=causal))
    _close(tl.attention_chunked(tq, tk, tv, causal=causal, chunk=16),
           jl.attention_chunked(jq, jk, jv, causal=causal, chunk=16))
    # a chunk that does not divide Sk falls back to the naive path in both
    _close(tl.attention_chunked(tq, tk, tv, causal=causal, chunk=24),
           jl.attention_naive(jq, jk, jv, causal=causal))


def test_attention_decode_per_row_positions():
    """The port takes one position per row; row b against the JAX function
    called on that row alone with its scalar position."""
    q, kc, vc = _rand(8, 3, 1, 4, 16), _rand(9, 3, 20, 2, 16), _rand(10, 3, 20, 2, 16)
    pos = np.array([0, 7, 19])
    got = tl.attention_decode(*map(torch.from_numpy, (q, kc, vc)), torch.from_numpy(pos))
    for b in range(3):
        want = jl.attention_decode(jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
                                   jnp.asarray(vc[b:b + 1]), int(pos[b]))
        _close(got[b:b + 1], want)


@pytest.mark.parametrize("arch", ["granite-3-8b", "starcoder2-15b"])  # silu and gelu
def test_mlp(arch):
    jcfg, tcfg = _configs(arch)
    from repro.models.params import init_params

    defs = jl.mlp_defs(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), init_params(defs, jax.random.PRNGKey(1)))
    jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}  # nonzero biases
    x = _rand(11, 2, 5, 64)
    got = tl.mlp_apply(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                       torch.from_numpy(x), tcfg)
    _close(got, jl.mlp_apply(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen1.5-110b", "granite-34b"])
def test_gqa_prefill_and_decode(arch):
    """Full-sequence GQA, then one decode step at per-row positions against
    the JAX decode of each row at its scalar position (cache written there)."""
    jcfg, tcfg = _configs(arch)
    from repro.models.params import init_params

    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_params(jl.gqa_defs(jcfg), jax.random.PRNGKey(2)))
    jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}  # nonzero biases
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _rand(12, 2, 9, 64)
    _close(tl.gqa_apply(tp, torch.from_numpy(x), tcfg), jl.gqa_apply(jp, jnp.asarray(x), jcfg))

    hd, kvh = tcfg.resolved_head_dim, tcfg.num_kv_heads
    xd = _rand(13, 2, 1, 64)
    kc, vc = _rand(14, 2, 12, kvh, hd), _rand(15, 2, 12, kvh, hd)
    pos = np.array([3, 11])
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, tk2, tv2 = tl.gqa_decode_apply(tp, torch.from_numpy(xd), tk, tv,
                                        torch.from_numpy(pos), tcfg)
    assert tk2 is tk and tv2 is tv  # written in place
    for b in range(2):
        w_out, w_k, w_v = jl.gqa_decode_apply(jp, jnp.asarray(xd[b:b + 1]),
                                              jnp.asarray(kc[b:b + 1]), jnp.asarray(vc[b:b + 1]),
                                              int(pos[b]), jcfg)
        _close(out[b:b + 1], w_out)
        _close(tk[b:b + 1], w_k)
        _close(tv[b:b + 1], w_v)


def test_embed_unembed_and_write_cache():
    jcfg, tcfg = _configs("granite-3-8b")
    emb = {"tokens": _rand(16, 512, 64), "unembed": _rand(17, 64, 512)}
    toks = np.array([[1, 5, 511]])
    te = {k: torch.from_numpy(v) for k, v in emb.items()}
    je = {k: jnp.asarray(v) for k, v in emb.items()}
    _close(tl.embed_apply(te, torch.from_numpy(toks), tcfg), jl.embed_apply(je, toks, jcfg), 0)
    x = _rand(18, 1, 3, 64)
    _close(tl.unembed_apply(te, torch.from_numpy(x), tcfg),
           jl.unembed_apply(je, jnp.asarray(x), jcfg), tol=1e-4)
    for update in ("dus", "onehot"):
        cache = torch.zeros(2, 6, 2, 4)
        new = torch.from_numpy(_rand(19, 2, 1, 2, 4))
        tl.write_cache(cache, new, torch.tensor([1, 5]),
                       dataclasses.replace(tcfg, cache_update=update))
        assert torch.equal(cache[0, 1], new[0, 0]) and torch.equal(cache[1, 5], new[1, 0])
        assert int((cache != 0).sum()) == int((new != 0).sum())
