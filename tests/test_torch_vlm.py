"""The vision-language model (internvl2-76b) of the port against the JAX
package, on the CPU at its reduced config (``frontend_seq`` = 8 patch rows),
in f32 with and without int8 weights: the config, RoPE at its base of
500000, ``forward``, ``prefill`` and ``decode_step`` with random patch
embeddings in place of the first ``frontend_seq`` positions, chunked
prefill whose chunk straddles ``frontend_seq`` against blocking prefill and
against the reference, the prompt shorter than ``frontend_seq`` (the
reference's edge, pinned as it is), and the engine: ``generate``, chunked
admission, speculative verify and poison/resume against the JAX engine.

f32 is held to 2e-5 of the largest magnitude (``test_torch_audio.close``),
int8 to the int8 rule of ``test_torch_chunked_prefill`` (max 0.1, mean 0.02
of the largest magnitude); f32 tokens are identical."""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_config
from repro.models import quant as jquant
from repro.models.layers import rope_frequencies as jax_rope_frequencies
from repro.models.model import forward as _jax_forward
from repro.models.model import param_defs as jax_param_defs
from repro.models.model import prefill as _jax_prefill
from repro.models.params import init_params as jax_init_params
from repro.serving.engine import InferenceEngine as JaxEngine, ServeConfig as JaxServeConfig
from repro.serving.kv_cache import cache_defs as jax_cache_defs
from repro_torch.configs import get_config, get_reduced_config as torch_config
from repro_torch.models import quant as tquant
from repro_torch.models.layers import rope_frequencies
from repro_torch.models.model import decode_step, forward, prefill, prefill_chunk
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serving.engine import InferenceEngine, ServeConfig
from repro_torch.serving.kv_cache import cache_defs
from repro_torch.serving.slots import grow_cache

from test_torch_audio import agree, as_tokens, close
from test_torch_moe import jax_quantize_weight, numpy_params

torch.set_num_threads(1)
ARCH = "internvl2-76b"
QUANTS = (None, "int8")
K = 3
S0 = 12            # longer than the reduced config's frontend_seq = 8
CHUNK = 5          # chunks 0-5, 5-10 (straddles position 8), 10-12
jax_forward = jax.jit(_jax_forward, static_argnums=2)
jax_prefill = jax.jit(_jax_prefill, static_argnums=2)


@functools.lru_cache(maxsize=None)
def pair(quant=None):
    """The JAX and the port engine over the same f32 weights."""
    jcfg = dataclasses.replace(jax_config(ARCH), dtype=jnp.float32, quant=quant)
    tcfg = dataclasses.replace(torch_config(ARCH), dtype=torch.float32, quant=quant)
    jp = numpy_params(jax_param_defs(jcfg), np.random.default_rng(0))
    if quant:
        with mock.patch.object(jquant, "_quantize_weight", jax_quantize_weight):
            jp = jquant.quantize_params(jp, jcfg)
    sc = dict(max_batch=4, max_len=32, spec_slack=K)
    return (JaxEngine(jcfg, params=jp, sc=JaxServeConfig(**sc)),
            InferenceEngine(tcfg, params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                            sc=ServeConfig(**sc), device="cpu"))


def prompts(seed: int, shape=(2, S0)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def patches(seed: int, seq: int, batch: int = 2) -> np.ndarray:
    """Random patch embeddings at the token embedding's scale (0.02)."""
    return (np.random.default_rng(seed).standard_normal((batch, seq, 64)) * 0.02).astype(
        np.float32)


def test_configs_are_the_reference_field_for_field():
    def fields(cfg):
        return {f.name: str(getattr(cfg, f.name)).replace("torch.", "").replace(
            "<class 'jax.numpy.", "").replace("'>", "") for f in dataclasses.fields(cfg)}

    assert fields(get_config(ARCH)) == fields(jax_get_config(ARCH))
    assert fields(torch_config(ARCH)) == fields(jax_config(ARCH))
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.d_ff, full.vocab_size, full.rope_theta, full.frontend_seq,
            full.tie_embeddings) == ("vlm", 80, 8192, 64, 8, 28672, 128256, 500_000.0, 256,
                                     False)


def test_every_architecture_and_family_of_the_reference_is_registered():
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs
    from repro_torch.models.model import _PORTED

    assert list_archs() == jax_list_archs() and len(list_archs()) == 10
    assert set(_PORTED) == {get_config(a).family for a in list_archs()} == {
        "dense", "vlm", "moe", "ssm", "hybrid", "audio"}


@pytest.mark.parametrize("dim", [16, 128])
def test_rope_frequencies_at_internvl2s_base_are_the_references_bits(dim):
    """``theta ** (arange / dim)`` at theta = 500000: the port's pow of an f32
    base, built on the device, gives the reference's bits (no linspace)."""
    got = rope_frequencies(dim, 500_000.0).numpy()
    want = np.asarray(jax_rope_frequencies(dim, 500_000.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant", QUANTS)
def test_forward_prefill_and_decode_with_patch_embeddings_match_jax(quant):
    je, te = pair(quant)
    p, fe = prompts(1), patches(2, 8)
    jh, _ = jax_forward(je.params, jnp.asarray(p), je.cfg, jnp.asarray(fe))
    jl, jc = jax_prefill(je.params, jnp.asarray(p), je.cfg, jnp.asarray(fe))
    with torch.inference_mode():
        th, _ = forward(te.params, as_tokens(p), te.cfg, torch.from_numpy(fe))
        tl, tc = prefill(te.params, as_tokens(p), te.cfg, frontend_embeds=torch.from_numpy(fe))
    agree(th, jh, quant)
    agree(tl, jl, quant)
    for key in ("k", "v"):
        agree(tc[key], jc[key], quant)
    # the patch rows are not the tokens' embeddings: the same prompt without
    # them gives other keys at the first frontend_seq positions only
    with torch.inference_mode():
        _, plain = prefill(te.params, as_tokens(p), te.cfg)
    assert not torch.allclose(plain["k"][0, :, :8], tc["k"][0, :, :8])
    assert torch.equal(plain["k"][0, :, 8:], tc["k"][0, :, 8:])
    tc = grow_cache(te.cfg, tc, te.capacity)
    jcache = {k: jnp.asarray(np.asarray(v)) for k, v in tc.items()}
    nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
    for j in range(2):
        jl, jcache = je._decode(je.params, jcache, jnp.asarray(nxt), jnp.int32(S0 + j))
        with torch.inference_mode():
            tl, tc = decode_step(te.params, tc, as_tokens(nxt), S0 + j, te.cfg)
        agree(tl, jl, quant)
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("quant", QUANTS)
def test_chunk_straddling_frontend_seq_composes_to_blocking_and_matches_jax(quant):
    """Chunks of 5 over 12 positions with 8 patch rows: the second chunk
    holds patch rows 5-7 and tokens 8-9.  The last chunk's logits and the
    cache are blocking prefill's (within the port) and the reference's
    chunked ones (across)."""
    je, te = pair(quant)
    p, fe = prompts(3), patches(4, 8)
    padded = np.zeros((2, te.capacity, 64), np.float32)
    padded[:, :8] = fe
    with torch.inference_mode():
        tl_block, tc_block = prefill(te.params, as_tokens(p), te.cfg,
                                     frontend_embeds=torch.from_numpy(fe))
    jc = jax_init_params(jax_cache_defs(je.cfg, batch=2, max_len=je.capacity),
                         jax.random.PRNGKey(0))
    tc = init_params(cache_defs(te.cfg, batch=2, max_len=te.capacity), torch.Generator(), "cpu")
    for pos in range(0, S0, CHUNK):
        toks = p[:, pos:pos + CHUNK]
        jl, jc = je._chunk(je.params, jc, jnp.asarray(toks), jnp.int32(pos), jnp.asarray(padded))
        with torch.inference_mode():
            tl, tc = prefill_chunk(te.params, tc, as_tokens(toks), pos, te.cfg,
                                   frontend_embeds=torch.from_numpy(padded))
        agree(tl, jl, quant)
    agree(tl, tl_block.numpy(), quant)
    for key in ("k", "v"):
        agree(tc[key], jc[key], quant)
        agree(tc[key][:, :, :S0], tc_block[key].numpy(), quant)
        assert not tc[key][:, :, S0:].any()


def test_a_prompt_shorter_than_frontend_seq_prefills_frontend_seq_positions_as_jax():
    """The reference's edge, kept: all ``frontend_seq`` patch rows are
    concatenated ahead of x[:, frontend_seq:], so a 5-token prompt with 8
    patch rows prefills 8 positions, its last logit at position 7, and
    ``generate`` decodes at 5, 6, ... over the image rows.  The port does
    the same, token for token.  Chunked prefill of the same prompt writes 5
    positions only, in both packages."""
    je, te = pair()
    p, fe = prompts(5, (2, 5)), patches(6, 8)
    jl, jc = jax_prefill(je.params, jnp.asarray(p), je.cfg, jnp.asarray(fe))
    with torch.inference_mode():
        tl, tc = prefill(te.params, as_tokens(p), te.cfg, frontend_embeds=torch.from_numpy(fe))
    assert tuple(tc["k"].shape[2:3]) == (8,) == jc["k"].shape[2:3]
    close(tl, jl)
    close(tc["k"], jc["k"])
    np.testing.assert_array_equal(te.generate(p, 6), je.generate(p, 6))
    tst = te.begin_chunked_prefill(te.make_pool(), [0, 1], p, rids=[0, 1], budgets=[4, 4])
    jst = je.begin_chunked_prefill(je.make_pool(), [0, 1], p, rids=[0, 1], budgets=[4, 4])
    while not tst.done:
        te.chunked_prefill_step(tst, 3)
        je.chunked_prefill_step(jst, 3)
    np.testing.assert_array_equal(tst.first, jst.first)
    close(tst.cache["k"], jst.cache["k"])
    assert not tst.cache["k"][:, :, 5:].any()


@pytest.mark.parametrize("quant", QUANTS)
def test_engine_generate_slots_and_chunked_admission_match_the_jax_engine(quant):
    """``generate`` (token for token in f32), then a pool: slot 3 decodes
    while a group of two prompts is admitted in chunks of 5 (one chunk
    straddles the stub's 8 patch rows); the group's first tokens are
    blocking admission's and the JAX engine's, and the ticks after agree."""
    je, te = pair(quant)
    p = prompts(7, (3, S0))
    got = te.generate(p, 6)
    if quant is None:
        np.testing.assert_array_equal(got, je.generate(p, 6))
    group = p[:2]
    out = {}
    for name, eng in (("jax", je), ("port", te)):
        pool = eng.make_pool()
        eng.prefill_into_slot(pool, 3, p[2], rid=0, budget=12)
        st = eng.begin_chunked_prefill(pool, [0, 1], group, rids=[1, 2], budgets=[6, 6])
        while not st.done:
            eng.chunked_prefill_step(st, CHUNK)
            nxt, _ = eng.masked_decode_step(pool)
            pool.advance(3, 1, int(nxt[3]))
        out[name] = (pool, eng.finish_chunked_prefill(pool, st))
    (tpool, tfirst), (jpool, jfirst) = out["port"], out["jax"]
    blocking = [te.prefill_into_slot(te.make_pool(), 0, group[j], rid=j, budget=6)
                for j in range(2)]
    if quant is None:
        np.testing.assert_array_equal(tfirst, jfirst)
        np.testing.assert_array_equal(tfirst, blocking)
    for key in tpool.cache:
        agree(tpool.cache[key][:, :2], np.asarray(jpool.cache[key])[:, :2], quant)
    for _ in range(2):
        live = tpool.decode_mask().copy()
        tn, tf = te.masked_decode_step(tpool)
        jn, _ = je.masked_decode_step(jpool)
        assert tf[live].all()
        if quant is None:
            np.testing.assert_array_equal(tn[live], jn[live])
        for s in np.flatnonzero(live):
            tpool.advance(int(s), 1, int(jn[s]))
            jpool.advance(int(s), 1, int(jn[s]))


@pytest.mark.parametrize("quant", QUANTS)
def test_speculative_ticks_and_poison_resume_match_plain_decode(quant):
    """Oracle drafts in slot 0 (accept all), always-wrong in slot 1 (accept
    0): the JAX engine's tokens and counts in f32, the plain chain
    committed; then slot 1 poisoned alone, retired and resumed, continuing
    its chain."""
    je, te = pair(quant)
    p = prompts(8, (1, S0))[0]
    ref = te.generate(p[None], 10)[0].tolist()
    jpool, tpool = je.make_pool(), te.make_pool()
    for s in (0, 1):
        assert te.prefill_into_slot(tpool, s, p, rid=s, budget=10) == ref[0]
        je.prefill_into_slot(jpool, s, p, rid=s, budget=10)
    got = {0: [ref[0]], 1: [ref[0]]}
    for _ in range(2):
        drafts = np.zeros((4, K), np.int32)
        e0, e1 = tpool.slots[0].emitted, tpool.slots[1].emitted
        drafts[0] = (ref[e0:e0 + K] + [0] * K)[:K]
        drafts[1] = [(x + 1) % 512 for x in (ref[e1:e1 + K] + [0] * K)[:K]]
        out, acc, fin = te.masked_speculative_step(tpool, drafts)
        assert fin[:2].all() and acc[0] == K and acc[1] == 0
        if quant is None:
            jout, jacc, _ = je.masked_speculative_step(jpool, drafts)
            np.testing.assert_array_equal(out[:2], jout[:2])
            np.testing.assert_array_equal(acc[:2], jacc[:2])
        for s in (0, 1):
            n = int(acc[s]) + 1
            got[s] += out[s, :n].tolist()
            tpool.advance(s, n, int(out[s, n - 1]))
            jpool.advance(s, n, int(out[s, n - 1]))
    for s in (0, 1):
        assert got[s] == ref[:len(got[s])]
    te.poison_slot(tpool, 1)
    nxt, fin = te.masked_decode_step(tpool)
    assert fin[0] and not fin[1]
    tpool.advance(0, 1, int(nxt[0]))
    tpool.retire(1)
    context = np.concatenate([p, np.asarray(got[1][:-1], np.int32)])
    te.resume_into_slot(tpool, 1, context, rid=1, budget=10, emitted=len(got[1]),
                        next_tok=got[1][-1])
    nxt, fin = te.masked_decode_step(tpool)
    assert fin[:2].all() and int(nxt[1]) == ref[len(got[1])]


def test_each_projection_is_one_int8_matmul_call(monkeypatch):
    """7 int8_matmul calls a layer (wq, wk, wv, wo, wg, wu, wd) at prefill,
    decode and chunk; the untied unembedding is a plain product."""
    _, te = pair("int8")
    calls = []
    real = tquant.int8_matmul
    monkeypatch.setattr(tquant, "int8_matmul", lambda *a: calls.append(a[0].shape[0]) or
                        real(*a))
    cfg = te.cfg
    with torch.inference_mode():
        _, cache = prefill(te.params, as_tokens(prompts(9)), cfg,
                           frontend_embeds=torch.from_numpy(patches(10, 8)))
        n_prefill = len(calls)
        cache = grow_cache(cfg, cache, te.capacity)
        decode_step(te.params, cache, as_tokens(prompts(11, (2, 1))), S0, cfg)
        n_decode = len(calls) - n_prefill
    assert (n_prefill, n_decode) == (7 * cfg.num_layers,) * 2
    assert set(calls[:n_prefill]) == {2 * S0} and set(calls[n_prefill:]) == {2}
    assert "unembed" in te.params["embed"] and not isinstance(te.params["embed"]["unembed"],
                                                              tquant.QuantTensor)
