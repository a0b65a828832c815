"""The audio family (whisper) served by the port against the JAX engine, on
the CPU at the reduced whisper-tiny config, in f32 with and without int8
weights: the cache layout (self-attention K/V that grow, cross K/V fixed at
``encoder_seq``), ``generate``, the masked decode tick, chunked admission
with its cross K/V from ``encoder_cross_cache`` against blocking admission,
speculative verify against plain decode (``tests/test_speculative.py``'s
whisper cases: accept-all, accept-0, the budget boundary), poison and
resume with the cross rows rewritten, and the pool's writes of the cross
rows.

The engines feed the encoder the front-end stub (zeros), as the JAX engine
does; the token embedding is drawn at std 1 (``test_torch_audio.weights``).
f32 logits agree to 2e-5 of their largest magnitude and f32 tokens are
identical; with int8 weights logits are held to the int8 rule of
``test_torch_chunked_prefill`` (max 0.1, mean 0.02 of the largest
magnitude)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_config
from repro.serving.engine import InferenceEngine as JaxEngine, ServeConfig as JaxServeConfig
from repro.serving.kv_cache import cache_bytes as jax_cache_bytes
from repro.serving.kv_cache import cache_defs as jax_cache_defs
from repro.serving.slots import grow_cache as jax_grow_cache
from repro_torch.configs import get_config, get_reduced_config as torch_config
from repro_torch.models.model import encoder_cross_cache, prefill
from repro_torch.serving.engine import InferenceEngine, ServeConfig
from repro_torch.serving.graphs import signature
from repro_torch.serving.kv_cache import cache_bytes, cache_defs, paged_keys
from repro_torch.serving.slots import grow_cache

from test_torch_audio import ARCH, agree, as_tokens, weights

torch.set_num_threads(1)
QUANTS = (None, "int8")
K = 3  # drafts a verify window
S0 = 7


@functools.lru_cache(maxsize=None)
def pair(quant=None):
    """The JAX and the port engine over the same weights."""
    jcfg, jp, tcfg, tp = weights(quant)
    sc = dict(max_batch=4, max_len=32, spec_slack=K)
    return (JaxEngine(jcfg, params=jp, sc=JaxServeConfig(**sc)),
            InferenceEngine(tcfg, params=tp, sc=ServeConfig(**sc), device="cpu"))


def prompts(seed: int, shape=(2, S0)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_cache_layouts_match_the_reference_and_the_cross_part_does_not_grow():
    """Leaf for leaf the JAX package's shapes and types, full and reduced;
    ``cache_bytes`` is JAX's, and its cross part (2 leaves x L x B x
    encoder_seq x KV x hd) is the same at every max_len."""
    for get_t, get_j in ((get_config, jax_get_config), (torch_config, jax_config)):
        t, j = get_t(ARCH), get_j(ARCH)
        td, jd = cache_defs(t, batch=3, max_len=40), jax_cache_defs(j, batch=3, max_len=40)
        assert {k: (d.shape, str(d.dtype).replace("torch.", "")) for k, d in td.items()} == \
            {k: (d.shape, str(np.dtype(d.dtype))) for k, d in jd.items()}
        for max_len in (40, 80, 448):
            assert cache_bytes(t, batch=3, max_len=max_len) == \
                jax_cache_bytes(j, batch=3, max_len=max_len)
        per_row = 2 * t.num_layers * 3 * t.num_kv_heads * t.resolved_head_dim * t.dtype.itemsize
        cross = per_row * t.encoder_seq
        for max_len in (40, 80, 448):
            assert cache_bytes(t, batch=3, max_len=max_len) == per_row * max_len + cross
    full = cache_defs(get_config(ARCH), batch=4, max_len=128)
    assert full["cross_k"].shape == (4, 4, 1500, 6, 64) == full["cross_v"].shape
    assert full["k"].shape == (4, 4, 128, 6, 64)
    # one slot's cross K/V at full width: 9.2 MB in bf16
    assert 2 * full["cross_k"].shape[0] * 1500 * 6 * 64 * 2 == 9_216_000
    assert paged_keys(get_config(ARCH)) == ("k", "v")


@pytest.mark.parametrize("quant", QUANTS)
def test_grow_cache_leaves_the_cross_leaves_at_encoder_seq(quant):
    je, te = pair(quant)
    fe = te._frontend_stub(2)
    with torch.inference_mode():
        _, tc = prefill(te.params, as_tokens(prompts(1)), te.cfg, frontend_embeds=fe)
    _, jc = je._prefill(je.params, jnp.asarray(prompts(1)), je._frontend_stub(2))
    tg, jg = grow_cache(te.cfg, tc, 40), jax_grow_cache(je.cfg, jc, 40)
    assert set(tg) == set(jg) == {"k", "v", "cross_k", "cross_v"}
    for key in tg:
        assert tuple(tg[key].shape) == jg[key].shape
        agree(tg[key], jg[key], quant)
    assert tg["cross_k"] is tc["cross_k"] and tg["cross_v"] is tc["cross_v"]
    assert tg["cross_k"].shape[2] == te.cfg.encoder_seq and tg["k"].shape[2] == 40


def test_frontend_stub_is_zeros_of_the_encoders_frames():
    _, te = pair()
    stub = te._frontend_stub(3)
    assert tuple(stub.shape) == (3, te.cfg.encoder_seq, te.cfg.d_model)
    assert stub.dtype == te.cfg.dtype and not stub.any()


@pytest.mark.parametrize("quant", QUANTS)
def test_generate_and_prefill_match_the_jax_engine(quant):
    """``generate`` token for token in f32 (and, with int8 weights, its
    prefill's logits to the int8 rule); the prompts' chains differ, so the
    tokens matter to the decoder."""
    je, te = pair(quant)
    p = prompts(2, (3, S0))
    jl, _ = je._prefill(je.params, jnp.asarray(p), je._frontend_stub(3))
    with torch.inference_mode():
        tl, _ = prefill(te.params, as_tokens(p), te.cfg, frontend_embeds=te._frontend_stub(3))
    agree(tl, jl, quant)
    got = te.generate(p, 8)
    if quant is None:
        np.testing.assert_array_equal(got, je.generate(p, 8))
        assert len({tuple(r) for r in got.tolist()}) > 1
    assert got.shape == (3, 8)


@pytest.mark.parametrize("quant", QUANTS)
def test_masked_decode_step_matches_the_jax_engine(quant):
    """Slots 0 and 2 admitted at tick 0, slot 3 at tick 1, slot 1 free: the
    same next tokens and finite flags as the JAX engine's vmapped masked
    step, and the same pool rows, cross rows included."""
    je, te = pair(quant)
    p = prompts(3, (3, S0))
    jpool, tpool = je.make_pool(), te.make_pool()
    for tick in range(3):
        for slot, row in {0: {0: 0, 2: 1}, 1: {3: 2}}.get(tick, {}).items():
            first = te.prefill_into_slot(tpool, slot, p[row], rid=slot, budget=8)
            jfirst = je.prefill_into_slot(jpool, slot, p[row], rid=slot, budget=8)
            assert first == jfirst or quant
        live = tpool.decode_mask().copy()
        tn, tf = te.masked_decode_step(tpool)
        jn, jf = je.masked_decode_step(jpool)
        if quant is None:
            np.testing.assert_array_equal(tn[live], jn[live])
        assert tf[live].all() and jf[live].all()
        for slot in np.flatnonzero(live):
            tpool.advance(int(slot), 1, int(jn[slot]))
            jpool.advance(int(slot), 1, int(jn[slot]))
        for key in tpool.cache:
            agree(tpool.cache[key][:, live], np.asarray(jpool.cache[key])[:, live], quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_admit_writes_every_leaf_of_the_slot_cross_rows_included(quant):
    """``prefill_into_slot`` lands the prefill's cross K/V in the slot's rows
    of the pool, in place, and leaves the other slots' rows as they were."""
    _, te = pair(quant)
    pool = te.make_pool()
    before = {k: v.clone() for k, v in pool.cache.items()}
    ids = {k: v.data_ptr() for k, v in pool.cache.items()}
    te.prefill_into_slot(pool, 2, prompts(4)[0], rid=0, budget=6)
    with torch.inference_mode():
        _, c = prefill(te.params, as_tokens(prompts(4)[:1]), te.cfg,
                       frontend_embeds=te._frontend_stub(1))
    for key in ("cross_k", "cross_v"):
        assert torch.equal(pool.cache[key][:, 2], c[key][:, 0])
        others = [s for s in range(4) if s != 2]
        assert torch.equal(pool.cache[key][:, others], before[key][:, others])
    assert {k: v.data_ptr() for k, v in pool.cache.items()} == ids


@pytest.mark.parametrize("quant", QUANTS)
def test_chunked_admission_equals_blocking_in_the_port_and_across(quant):
    """A group of two prompts in chunks of 3 while slot 3 decodes: the
    group's cache starts with its cross K/V from ``encoder_cross_cache`` of
    the stub (JAX's), the group's first tokens and every pool row after
    ``finish`` are blocking admission's (within the port) and the JAX
    engine's chunked ones (across), and the tokens of the ticks after it
    too (f32)."""
    je, te = pair(quant)
    p0, group = prompts(5, (1, 6))[0], prompts(6)
    kw = dict(rids=[1, 2], budgets=[6, 6])
    pools = {}
    for name, eng in (("jax", je), ("port", te)):
        pool = eng.make_pool()
        eng.prefill_into_slot(pool, 3, p0, rid=0, budget=12)
        st = eng.begin_chunked_prefill(pool, [0, 1], group, **kw)
        if name == "port":
            with torch.inference_mode():
                ck, cv = encoder_cross_cache(te.params, te.cfg, te._frontend_stub(2))
            assert torch.equal(st.cache["cross_k"], ck) and torch.equal(st.cache["cross_v"], cv)
            assert not st.cache["k"].any()
        else:
            jst = st
        while not st.done:
            eng.chunked_prefill_step(st, 3)
            nxt, _ = eng.masked_decode_step(pool)
            pool.advance(3, 1, int(nxt[3]))
        pools[name] = (pool, eng.finish_chunked_prefill(pool, st))
    agree(st.cache["cross_k"], jst.cache["cross_k"], quant)
    (tpool, tfirst), (jpool, jfirst) = pools["port"], pools["jax"]
    block = te.make_pool()
    bfirst = [te.prefill_into_slot(block, j, group[j], rid=j, budget=6) for j in range(2)]
    if quant is None:
        np.testing.assert_array_equal(tfirst, jfirst)
        np.testing.assert_array_equal(tfirst, bfirst)
    for key in tpool.cache:
        agree(tpool.cache[key][:, :2], np.asarray(jpool.cache[key])[:, :2], quant)
        n = S0 if key in ("k", "v") else None
        agree(tpool.cache[key][:, :2, :n], block.cache[key][:, :2, :n].numpy(), quant)
    for _ in range(3):
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
def test_chunk_step_probe_runs_on_a_zero_cross_cache_as_jax(quant):
    je, te = pair(quant)
    got = te.chunk_step_probe(2, 4)()
    agree(got, je.chunk_step_probe(2, 4)(), quant)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("quant", QUANTS)
def test_speculative_ticks_accept_all_0_and_1_and_commit_plain_decodes_chain(quant):
    """Slot 0 oracle drafts (accepts K), slot 1 always-wrong drafts (accepts
    0), slot 2 right for its first draft only (accepts 1), slot 3 free: in
    f32 tick for tick the JAX engine's tokens and counts; what each slot
    commits is the plain greedy chain."""
    je, te = pair(quant)
    p = prompts(7)[0]
    ref = te.generate(p[None], 12)[0].tolist()
    jpool, tpool = je.make_pool(), te.make_pool()
    for slot in (0, 1, 2):
        assert te.prefill_into_slot(tpool, slot, p, rid=slot, budget=12) == ref[0]
        je.prefill_into_slot(jpool, slot, p, rid=slot, budget=12)
    got = {s: [ref[0]] for s in range(3)}
    for _ in range(2):
        drafts = np.zeros((4, K), np.int32)
        for s, kind in enumerate(("oracle", "wrong", "first")):
            e = tpool.slots[s].emitted
            want = (ref[e:e + K] + [0] * K)[:K]
            drafts[s] = want if kind == "oracle" else [(x + 1) % 512 for x in want]
            if kind == "first":
                drafts[s, 0] = want[0]
        out, acc, fin = te.masked_speculative_step(tpool, drafts)
        assert fin[:3].all()
        assert acc[0] == K and acc[1] == 0 and acc[2] == 1
        if quant is None:
            jout, jacc, _ = je.masked_speculative_step(jpool, drafts)
            np.testing.assert_array_equal(out[:3], jout[:3])
            np.testing.assert_array_equal(acc[:3], jacc[:3])
        for s in range(3):
            n = int(acc[s]) + 1
            got[s] += out[s, :n].tolist()
            tpool.advance(s, n, int(out[s, n - 1]))
            jpool.advance(s, n, int(out[s, n - 1]))
    for s in range(3):
        assert got[s] == ref[:len(got[s])]


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_speculative_budget_boundary_emits_exactly_the_budget(budget):
    """``tests/test_speculative.py``'s whisper case on the engine: verify
    windows of K = 6 oracle drafts, acceptance truncated at the budget by
    the caller, give exactly ``budget`` tokens, ``generate``'s."""
    _, _, tcfg, tp = weights(None)
    te = InferenceEngine(tcfg, params=tp, sc=ServeConfig(max_batch=2, max_len=32, spec_slack=6),
                         device="cpu")
    prompt = np.random.default_rng(1).integers(0, 512, 4).astype(np.int32)
    ref = te.generate(prompt[None], budget)[0].tolist()
    pool = te.make_pool()
    toks = [te.prefill_into_slot(pool, 0, prompt, rid=0, budget=budget)]
    while len(toks) < budget:
        drafts = np.zeros((2, 6), np.int32)
        drafts[0] = (ref[len(toks):] + [0] * 6)[:6]
        out, acc, fin = te.masked_speculative_step(pool, drafts)
        n = min(int(acc[0]) + 1, budget - len(toks))
        toks += out[0, :n].tolist()
        pool.advance(0, n, int(out[0, n - 1]))
    assert toks == ref and len(toks) == budget


@pytest.mark.parametrize("quant", QUANTS)
def test_poisoned_slot_is_isolated_and_its_cross_rows_rewritten_on_resume(quant):
    """NaN in slot 1's rows, cross rows included, flags slot 1 alone; the
    others decode as a clean pool does; ``resume_into_slot`` rewrites every
    leaf of the slot, its cross K/V the bits of a fresh prefill's, and the
    resumed request continues its fault-free chain."""
    _, te = pair(quant)
    p = prompts(8, (3, S0))
    pools = [te.make_pool(), te.make_pool()]
    chains = [{s: [te.prefill_into_slot(pool, s, p[s], rid=s, budget=10)] for s in range(3)}
              for pool in pools]
    for pool, chain in zip(pools, chains):
        nxt, _ = te.masked_decode_step(pool)
        for s in range(3):
            pool.advance(s, 1, int(nxt[s]))
            chain[s].append(int(nxt[s]))
    clean, bad = pools
    te.poison_slot(bad, 1)
    assert torch.isnan(bad.cache["cross_k"][:, 1]).all()
    nb, fb = te.masked_decode_step(bad)
    nc, fc = te.masked_decode_step(clean)
    assert fc[:3].all() and not fb[1] and fb[[0, 2]].all()
    np.testing.assert_array_equal(nb[[0, 2]], nc[[0, 2]])
    for s in (0, 2):
        bad.advance(s, 1, int(nb[s]))
    clean.advance(1, 1, int(nc[1]))
    bad.retire(1)
    context = np.concatenate([p[1], np.asarray(chains[1][1][:-1], np.int32)])
    te.resume_into_slot(bad, 1, context, rid=1, budget=10, emitted=2, next_tok=chains[1][1][-1])
    with torch.inference_mode():
        _, fresh = prefill(te.params, as_tokens(context[None]), te.cfg,
                           frontend_embeds=te._frontend_stub(1))
    for key in ("cross_k", "cross_v"):
        assert torch.equal(bad.cache[key][:, 1], fresh[key][:, 0])
    nb, fb = te.masked_decode_step(bad)
    assert fb[:3].all() and nb[1] == nc[1]


def test_step_graph_signature_covers_the_cross_leaves():
    """A captured tick reads cross_k/cross_v at their addresses: the graph's
    signature holds them, and a pool never rebinds them."""
    _, te = pair()
    pool = te.make_pool()
    te.prefill_into_slot(pool, 0, prompts(9)[0], rid=0, budget=4)
    te.masked_decode_step(pool)
    g = te.step_graphs(pool)[("decode", 0)]
    assert (pool.cache["cross_k"].data_ptr(), tuple(pool.cache["cross_k"].shape)) in g.signature
    rebound = dict(pool.cache, cross_k=pool.cache["cross_k"].clone())
    assert signature(rebound, pool.max_batch, 0) != g.signature
    ptrs = {k: v.data_ptr() for k, v in pool.cache.items()}
    te.masked_speculative_step(pool, np.zeros((4, K), np.int32))
    te.poison_slot(pool, 0)
    assert {k: v.data_ptr() for k, v in pool.cache.items()} == ptrs


def test_full_config_engine_defs_at_full_width():
    """whisper-tiny at full width builds its parameter and cache trees: 4 + 4
    layers, the tied 51865-row table padded to 51968 (a multiple of 256), the cross K/V of 1500
    frames (no weights are drawn)."""
    from repro_torch.models.model import param_defs

    cfg = get_config(ARCH)
    defs = param_defs(cfg)
    assert defs["enc_blocks"]["attn"]["wq"].shape == (4, 384, 6, 64)
    assert defs["blocks"]["cross_attn"]["wk"].shape == (4, 384, 6, 64)
    assert defs["embed"]["tokens"].shape == (cfg.padded_vocab, 384) and "unembed" not in \
        defs["embed"]
    assert cfg.padded_vocab == 51968
