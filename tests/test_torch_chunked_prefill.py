"""Chunked prefill of the port against the JAX package, in f32 on the CPU:
``prefill_chunk`` composed over chunks of 1, 3 and 7 tokens against JAX's
blocking ``prefill`` and its own ``prefill_chunk``, for the four dense archs
with and without int8 weights, and the engine's chunked-admission lifecycle
(``begin`` / ``step`` / ``finish`` / ``cancel_chunked_prefill``) against the
JAX engine on the same pool history.

Logits and caches agree to 1e-4 of their largest magnitude (``close``);
tokens are identical.  With int8 weights the two frameworks differ where an
activation lies within f32 rounding of an edge of its int8 row quantization:
one step of ``amax / 127`` (``test_torch_quant_serving``).  Such a flip moves
the next layer's inputs far more than f32 rounding does, so more of its
activations cross edges, and from there on the row differs at the level of
int8 quantization noise.
This test's own granite-34b prompts hold such a flip (position 5 of the
first prompt): it moves that position's logits by 7.3% of their largest
magnitude, 0.95% on average over the two rows.  The int8 rule
(``close_q8``) is therefore that noise level: at most 0.1 of the largest
magnitude, 0.02 on average.  A wrong projection layout, scale, position or
mask is off by tens of percent; the f32 tests hold the same code to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.params import init_params as jax_init_params
from repro.serving.kv_cache import cache_defs as jax_cache_defs
from repro_torch.models.model import prefill, prefill_chunk
from repro_torch.models.params import init_params
from repro_torch.serving.kv_cache import cache_defs

from test_torch_dense_serving import DENSE, close, engines

torch.set_num_threads(1)
PROMPT = 14


def blocking(je, te, prompts):
    """Both packages' blocking prefill: (JAX logits, cache; port logits, cache)."""
    jl, jc = je._prefill(je.params, jnp.asarray(prompts), None)
    with torch.inference_mode():
        tl, tc = prefill(te.params, torch.as_tensor(prompts.astype(np.int64)), te.cfg)
    return jl, jc, tl, tc


Q8_MAX, Q8_MEAN = 0.1, 0.02


def close_q8(got: torch.Tensor, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got.numpy() - want)
    assert err.max() <= Q8_MAX * scale and err.mean() <= Q8_MEAN * scale, (err.max(), err.mean())


def agree(got, want, quant):
    (close if quant is None else close_q8)(got, want)


def chunked(je, te, prompts, chunk, frontend=None):
    """Both packages' ``prefill_chunk`` over ``prompts`` in chunks of
    ``chunk`` tokens, from zeroed full-capacity caches; each chunk's logits
    compared as it comes.  Returns both final caches."""
    b, s0 = prompts.shape
    quant = te.cfg.quant
    jc = jax_init_params(jax_cache_defs(je.cfg, batch=b, max_len=je.capacity),
                         jax.random.PRNGKey(0))
    tc = init_params(cache_defs(te.cfg, batch=b, max_len=te.capacity), torch.Generator(), "cpu")
    jfe = None if frontend is None else jnp.asarray(frontend)
    tfe = None if frontend is None else torch.from_numpy(frontend)
    for pos in range(0, s0, chunk):
        toks = prompts[:, pos:pos + chunk]
        jl, jc = je._chunk(je.params, jc, jnp.asarray(toks), jnp.int32(pos), jfe)
        with torch.inference_mode():
            tl, tc = prefill_chunk(te.params, tc, torch.as_tensor(toks.astype(np.int64)), pos,
                                   te.cfg, frontend_embeds=tfe)
        agree(tl, jl, quant)
    return jc, tc


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_chunk_composes_to_prefill(arch, quant):
    je, te = engines(arch, quant=quant, max_len=32)
    prompts = np.random.default_rng(11).integers(0, te.cfg.vocab_size, (2, PROMPT)).astype(
        np.int32)
    jl_block, jc_block, tl_block, tc_block = blocking(je, te, prompts)
    for chunk in (1, 3, 7):
        jc, tc = chunked(je, te, prompts, chunk)
        for key in ("k", "v"):
            # JAX's chunked cache, and the rows of both blocking prefills
            agree(tc[key], jc[key], quant)
            agree(tc[key][:, :, :PROMPT], jc_block[key], quant)
            agree(tc[key][:, :, :PROMPT], tc_block[key].numpy(), quant)
            assert not tc[key][:, :, PROMPT:].any()  # rows past the prompt stay dead
    agree(tl_block, jl_block, quant)


def test_prefill_chunk_vlm_slices_the_frontend_at_each_offset():
    """vlm: the capacity-padded frontend embeds replace the first
    ``frontend_seq`` token embeddings, sliced at each chunk's offset."""
    je, te = engines("granite-3-8b", max_len=32, family="vlm", frontend="vision",
                     frontend_seq=5)
    prompts = np.random.default_rng(12).integers(0, te.cfg.vocab_size, (2, 9)).astype(np.int32)
    fe = np.random.default_rng(13).standard_normal((2, te.capacity, te.cfg.d_model)).astype(
        np.float32)
    jc, tc = chunked(je, te, prompts, 3, frontend=fe)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_chunked_admission_lifecycle_matches_jax_engine(quant):
    """A decoding slot ticks between the chunks of a two-request group; the
    group's first tokens, the pools' views after every step and the tokens
    of the decode ticks after ``finish`` are the JAX engine's."""
    je, te = engines("granite-3-8b", quant=quant, max_batch=4, max_len=40)
    rng = np.random.default_rng(14)
    jpool, tpool = je.make_pool(), te.make_pool()
    p0 = rng.integers(0, te.cfg.vocab_size, 6).astype(np.int32)
    assert te.prefill_into_slot(tpool, 3, p0, rid=0, budget=12) == \
        je.prefill_into_slot(jpool, 3, p0, rid=0, budget=12)
    group = rng.integers(0, te.cfg.vocab_size, (2, 10)).astype(np.int32)
    kw = dict(rids=[1, 2], budgets=[5, 6])
    jst = je.begin_chunked_prefill(jpool, [0, 1], group, **kw)
    tst = te.begin_chunked_prefill(tpool, [0, 1], group, **kw)

    def same_views():
        for name in ("active", "admitting", "tok"):
            np.testing.assert_array_equal(getattr(tpool, name), getattr(jpool, name))
        np.testing.assert_array_equal(tpool.decode_mask(), jpool.decode_mask())
        np.testing.assert_array_equal(tpool.positions(), jpool.positions())
        assert tpool.free_slots() == jpool.free_slots()

    def tick():
        live = tpool.decode_mask().copy()
        tn, tf = te.masked_decode_step(tpool)
        jn, jf = je.masked_decode_step(jpool)
        np.testing.assert_array_equal(tn[live], jn[live])
        np.testing.assert_array_equal(tf[live], jf[live])
        for s in np.flatnonzero(live):
            tpool.advance(int(s), 1, int(tn[s]))
            jpool.advance(int(s), 1, int(jn[s]))
        same_views()

    same_views()
    while not tst.done:
        assert te.chunked_prefill_step(tst, 4) == je.chunked_prefill_step(jst, 4)
        assert tst.pos == jst.pos
        tick()  # slot 3 decodes while the group prefills
    agree(tst.cache["k"], jst.cache["k"], quant)
    np.testing.assert_array_equal(te.finish_chunked_prefill(tpool, tst),
                                  je.finish_chunked_prefill(jpool, jst))
    same_views()
    for _ in range(3):
        tick()
    assert tpool.committed == jpool.committed


def test_cancel_chunked_prefill_frees_the_group_slots():
    je, te = engines("granite-3-8b", max_batch=3, max_len=24)
    prompts = np.random.default_rng(15).integers(0, te.cfg.vocab_size, (2, 5)).astype(np.int32)
    for eng in (je, te):
        pool = eng.make_pool()
        st = eng.begin_chunked_prefill(pool, [2, 0], prompts, rids=[7, 8], budgets=[3, 3])
        assert list(np.flatnonzero(pool.admitting)) == [0, 2]
        assert pool.free_slots() == [1] and pool.decoding_count == 0
        eng.chunked_prefill_step(st, 2)
        eng.cancel_chunked_prefill(pool, st)
        assert pool.free_slots() == [1, 2, 0] and pool.active_count == 0
        assert not pool.admitting.any()
    with pytest.raises(ValueError, match="max_len"):
        te.begin_chunked_prefill(te.make_pool(), [0], prompts[:1], rids=[0], budgets=[20])


def test_chunk_step_probe_returns_logits_of_the_group():
    _, te = engines("granite-3-8b", max_len=24)
    probe = te.chunk_step_probe(3, 4)
    logits = probe()
    assert tuple(logits.shape) == (3, te.cfg.padded_vocab)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert torch.equal(probe(), logits)  # the probe's cache is rewritten, not grown
