"""The ssm and hybrid families served by the port against the JAX engine, on
the CPU at the reduced configs of mamba2-780m (a Mamba2 stack) and zamba2-7b
(Mamba2 segments of ``attn_every`` layers, each after the one weight-shared
attention block), in f32 with and without int8 weights: configs, cache
layouts, ``forward``, prefill and decode logits, ``generate``, the masked
decode tick, chunked prefill against blocking prefill and speculative
verify against plain decode (within each framework and across them: the
identities ``tests/test_serving.py`` and ``tests/test_speculative.py``
assert inside JAX), verify's rollback of each row to its own accepted
count, poison isolation, the short-prompt conv tail, and the int8
projections one ``int8_matmul`` call each.

f32 logits agree to 1e-4 of their largest magnitude and f32 tokens are
identical; with int8 weights logits are held to the int8 rule of
``test_torch_chunked_prefill`` (max 0.1, mean 0.02 of the largest
magnitude)."""
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
from repro.models.model import commit_verify as jax_commit_verify
from repro.models.model import decode_verify as _jax_decode_verify
from repro.models.model import forward as _jax_forward
from repro.models.model import param_defs as jax_param_defs
from repro.models.params import init_params as jax_init_params
from repro.serving.engine import InferenceEngine as JaxEngine, ServeConfig as JaxServeConfig
from repro.serving.kv_cache import cache_bytes as jax_cache_bytes
from repro.serving.kv_cache import cache_defs as jax_cache_defs
from repro.serving.slots import grow_cache as jax_grow_cache
from repro_torch.configs import get_config, get_reduced_config as torch_config
from repro_torch.models import quant as tquant
from repro_torch.models.model import (
    _hybrid_segments, commit_verify, decode_step, decode_verify, forward, init_model, prefill,
    prefill_chunk,
)
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serving.engine import InferenceEngine, ServeConfig
from repro_torch.serving.kv_cache import cache_bytes, cache_defs, paged_keys
from repro_torch.serving.slots import grow_cache

from test_torch_chunked_prefill import agree
from test_torch_dense_serving import close
from test_torch_moe import jax_quantize_weight, numpy_params

torch.set_num_threads(1)
ARCHS = ("mamba2-780m", "zamba2-7b")
QUANTS = (None, "int8")
jax_forward = jax.jit(_jax_forward, static_argnums=2)
jax_decode_verify = jax.jit(_jax_decode_verify, static_argnums=4)
K = 3  # drafts a verify window: T = K + 1


@functools.lru_cache(maxsize=None)
def pair(arch: str, quant=None):
    """The JAX and the port engine over the same f32 weights (the same for
    both ``quant``)."""
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32, quant=quant)
    tcfg = dataclasses.replace(torch_config(arch), dtype=torch.float32, quant=quant)
    jp = numpy_params(jax_param_defs(jcfg), np.random.default_rng(0))
    if quant:
        with mock.patch.object(jquant, "_quantize_weight", jax_quantize_weight):
            jp = jquant.quantize_params(jp, jcfg)
    sc = dict(max_batch=4, max_len=32, spec_slack=K)
    je = JaxEngine(jcfg, params=jp, sc=JaxServeConfig(**sc))
    te = InferenceEngine(tcfg, params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                         sc=ServeConfig(**sc), device="cpu")
    return je, te


S0 = 7  # every prompt of this file but the short ones: one shape, compiled once


def prompts(seed: int, shape=(2, S0), vocab: int = 512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def as_tokens(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def clone(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items()}


def test_configs_are_the_reference_field_for_field():
    def fields(cfg):
        out = {}
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            out[f.name] = fields(v) if dataclasses.is_dataclass(v) else str(v).replace(
                "torch.", "").replace("<class 'jax.numpy.", "").replace("'>", "")
        return out

    for arch in ARCHS:
        for get_t, get_j in ((get_config, jax_get_config), (torch_config, jax_config)):
            assert fields(get_t(arch)) == fields(get_j(arch))


def test_cache_layouts_match_the_reference():
    """Leaf for leaf the JAX package's shapes and types; ssm's cache does not
    grow with max_len, hybrid's shared K/V does; zamba2-7b's 81 layers make
    14 segments, the last of 3 layers."""
    for arch in ARCHS:
        for get_t, get_j in ((get_config, jax_get_config), (torch_config, jax_config)):
            t, j = get_t(arch), get_j(arch)
            td, jd = cache_defs(t, batch=3, max_len=40), jax_cache_defs(j, batch=3, max_len=40)
            assert {k: (d.shape, str(d.dtype).replace("torch.", "")) for k, d in td.items()} == \
                {k: (d.shape, str(np.dtype(d.dtype))) for k, d in jd.items()}
            for max_len in (40, 80):
                assert cache_bytes(t, batch=3, max_len=max_len) == \
                    jax_cache_bytes(j, batch=3, max_len=max_len)
    ssm = get_config("mamba2-780m")
    assert cache_bytes(ssm, batch=2, max_len=64) == cache_bytes(ssm, batch=2, max_len=4096)
    c = cache_defs(ssm, batch=4, max_len=16)
    assert c["conv"].shape == (48, 4, 3, 3072 + 256) and c["state"].shape == (48, 4, 48, 64, 128)
    assert c["state"].dtype == torch.float32 and c["conv"].dtype == torch.bfloat16
    z = get_config("zamba2-7b")
    segs = _hybrid_segments(z)
    assert len(segs) == 14 and segs[-1] == (78, 3)
    assert cache_defs(z, batch=4, max_len=16)["shared_k"].shape == (14, 4, 16, 32, 112)
    assert paged_keys(ssm) == () and paged_keys(z) == ("shared_k", "shared_v")


@pytest.mark.parametrize("arch", ARCHS)
def test_grow_cache_grows_only_the_sequence_leaves(arch):
    je, te = pair(arch)
    with torch.inference_mode():
        _, tc = prefill(te.params, as_tokens(prompts(1)), te.cfg)
    _, jc = je._prefill(je.params, jnp.asarray(prompts(1)), None)
    tg, jg = grow_cache(te.cfg, tc, 40), jax_grow_cache(je.cfg, jc, 40)
    assert set(tg) == set(jg)
    for key in tg:
        assert tuple(tg[key].shape) == jg[key].shape
        assert (tg[key] is tc[key]) == (key in ("conv", "state"))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_and_generate_match_jax(arch, quant):
    je, te = pair(arch, quant)
    p = prompts(1)
    jh, _ = jax_forward(je.params, jnp.asarray(p), je.cfg)
    jl, jc = je._prefill(je.params, jnp.asarray(p), None)
    with torch.inference_mode():
        th, taux = forward(te.params, as_tokens(p), te.cfg)
        tl, tc = prefill(te.params, as_tokens(p), te.cfg)
    agree(th, jh, quant)
    assert float(taux) == 0.0
    agree(tl, jl, quant)
    assert set(tc) == set(jc)
    for key in tc:
        agree(tc[key], jc[key], quant)
    jc = jax_grow_cache(je.cfg, jc, je.capacity)
    tc = grow_cache(te.cfg, tc, te.capacity)
    nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
    for j in range(2):
        jl2, jc = je._decode(je.params, jc, jnp.asarray(nxt), jnp.int32(S0 + j))
        with torch.inference_mode():
            tl2, tc = decode_step(te.params, tc, as_tokens(nxt), S0 + j, te.cfg)
        agree(tl2, jl2, quant)
        for key in tc:
            agree(tc[key], jc[key], quant)
        nxt = np.argmax(np.asarray(jl2), axis=-1)[:, None].astype(np.int32)
    if quant is None:
        np.testing.assert_array_equal(te.generate(p, 6), je.generate(p, 6))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_masked_decode_step_matches_jax_engine(arch, quant):
    """Slots 0 and 2 admitted at tick 0, slot 3 at tick 1, slot 1 free (it
    steps at position 0 and its rows are dead): the same next tokens and
    finite flags as the JAX engine's vmapped masked step, tick after
    tick."""
    je, te = pair(arch, quant)
    p = prompts(2, (3, S0))
    jpool, tpool = je.make_pool(), te.make_pool()
    for tick in range(3):
        for slot, row in {0: {0: 0, 2: 1}, 1: {3: 2}}.get(tick, {}).items():
            assert te.prefill_into_slot(tpool, slot, p[row], rid=slot, budget=8) == \
                je.prefill_into_slot(jpool, slot, p[row], rid=slot, budget=8)
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
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_blocking_prefill_in_both_and_across(arch, quant):
    """Chunks of 3 tokens over a 7-token prompt carry the conv tail and state
    (and hybrid's shared K/V) to blocking prefill's, in the port and in JAX,
    and the port's are JAX's."""
    je, te = pair(arch, quant)
    p = prompts(3)
    jl_block, jc_block = je._prefill(je.params, jnp.asarray(p), None)
    jc = jax_init_params(jax_cache_defs(je.cfg, batch=2, max_len=je.capacity),
                         jax.random.PRNGKey(0))
    tc = init_params(cache_defs(te.cfg, batch=2, max_len=te.capacity), torch.Generator(), "cpu")
    with torch.inference_mode():
        tl_block, tc_block = prefill(te.params, as_tokens(p), te.cfg)
        for pos in range(0, S0, 3):
            jl, jc = je._chunk(je.params, jc, jnp.asarray(p[:, pos:pos + 3]), jnp.int32(pos),
                               None)
            tl, tc = prefill_chunk(te.params, tc, as_tokens(p[:, pos:pos + 3]), pos, te.cfg)
            agree(tl, jl, quant)
    agree(tl, np.asarray(tl_block), quant)                     # within the port
    agree(torch.from_numpy(np.asarray(jl)), jl_block, quant)  # within JAX
    agree(tl, jl_block, quant)                                 # across
    for key in tc:
        seq = key.startswith("shared")
        agree(tc[key][:, :, :S0] if seq else tc[key], tc_block[key].numpy(), quant)
        agree(tc[key], jc[key], quant)
        if seq:
            assert not tc[key][:, :, S0:].any()  # rows past the prompt stay dead


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_rolls_each_row_back_to_its_own_accepted_count(arch, quant):
    """A window of K+1 = 4 tokens scored in one pass is the 4 decode steps'
    logits, in the port and in JAX and across; committing accepted counts
    that differ by row leaves each row's conv and state where a+1 decode
    steps leave them (and where JAX's snapshot a is), the shared K/V
    untouched by the commit."""
    je, te = pair(arch, quant)
    p, window = prompts(4), prompts(5, (2, K + 1))
    _, jc = je._prefill(je.params, jnp.asarray(p), None)
    jc = jax_grow_cache(je.cfg, jc, je.capacity)
    jv, jvc = jax_decode_verify(je.params, jc, jnp.asarray(window), jnp.int32(S0), je.cfg)
    with torch.inference_mode():
        _, tc = prefill(te.params, as_tokens(p), te.cfg)
        tc = grow_cache(te.cfg, tc, te.capacity)
        before = clone(tc)
        tv, tvc = decode_verify(te.params, tc, as_tokens(window), S0, te.cfg)
        for key in ("conv", "state"):  # verify leaves the recurrent leaves as they were
            assert torch.equal(tc[key], before[key])
        steps, after = [], []
        dc = clone(before)
        for j in range(K + 1):
            lj, dc = decode_step(te.params, dc, as_tokens(window[:, j:j + 1]), S0 + j, te.cfg)
            steps.append(lj.numpy())
            after.append(clone(dc))
    agree(tv, np.stack(steps, axis=1), quant)  # within the port
    agree(tv, jv, quant)                       # across
    for acc in ([0, K], [2, 0], [1, 1]):
        c = dict(clone(tc), verify=tvc["verify"])
        with torch.inference_mode():
            c = commit_verify(c, torch.tensor(acc), te.cfg)
        assert "verify" not in c and set(c) == set(tc)
        jrows = [jax_commit_verify(jax.tree.map(lambda a: a[:, b:b + 1], jvc), a, je.cfg)
                 for b, a in enumerate(acc)]
        for b, a in enumerate(acc):
            for key in ("conv", "state"):
                agree(c[key][:, b], after[a][key][:, b].numpy(), quant)     # a+1 decode steps
                agree(c[key][:, b], np.asarray(jrows[b][key])[:, 0], quant)  # JAX's snapshot a
        for key in set(c) - {"conv", "state"}:  # positional: written by verify, kept
            assert torch.equal(c[key], tc[key])
            agree(c[key][:, :, :S0 + K + 1], after[K][key][:, :, :S0 + K + 1].numpy(), quant)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_ticks_match_jax_with_rows_accepting_0_some_and_all(arch, quant):
    """The engines' verify ticks: slot 0 oracle drafts (accepts K), slot 1
    always-wrong drafts (accepts 0), slot 2 right for its first draft only
    (accepts 1), slot 3 free.  Tick for tick the JAX engine's tokens and
    counts (in f32), and the tokens committed are plain decode's."""
    je, te = pair(arch, quant)
    p = prompts(6)[0]
    ref = [te.prefill_into_slot(pool := te.make_pool(), 0, p, rid=0, budget=12)]
    for _ in range(11):
        nxt, _ = te.masked_decode_step(pool)
        pool.advance(0, 1, int(nxt[0]))
        ref.append(int(nxt[0]))
    jpool, tpool = je.make_pool(), te.make_pool()
    for slot in (0, 1, 2):
        assert te.prefill_into_slot(tpool, slot, p, rid=slot, budget=12) == \
            je.prefill_into_slot(jpool, slot, p, rid=slot, budget=12) == ref[0]
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
            jout, jacc, jfin = je.masked_speculative_step(jpool, drafts)
            np.testing.assert_array_equal(out[:3], jout[:3])
            np.testing.assert_array_equal(acc[:3], jacc[:3])
            assert jfin[:3].all()
        for s in range(3):
            n = int(acc[s]) + 1
            got[s] += out[s, :n].tolist()
            tpool.advance(s, n, int(out[s, n - 1]))
            jpool.advance(s, n, int(out[s, n - 1]))
    for s in range(3):  # what each slot committed is the plain greedy chain
        assert got[s] == ref[:len(got[s])]


@pytest.mark.parametrize("arch", ARCHS)
def test_poisoned_slot_is_isolated_and_resumes(arch):
    """NaN in one slot's conv/state (and shared K/V) rows flags that slot
    alone; the others decode as a clean pool does, and the resumed request
    continues its fault-free chain."""
    _, te = pair(arch)
    p = prompts(7, (3, S0))
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
    nb, fb = te.masked_decode_step(bad)
    nc, fc = te.masked_decode_step(clean)
    assert fc[:3].all() and not fb[1] and fb[[0, 2]].all()
    np.testing.assert_array_equal(nb[[0, 2]], nc[[0, 2]])
    for s in (0, 2):
        bad.advance(s, 1, int(nb[s]))
    clean.advance(1, 1, int(nc[1]))
    bad.retire(1)
    context = np.concatenate([p[1], np.asarray(chains[1][1][:-1], np.int32)])
    te.resume_into_slot(bad, 1, context, rid=1, budget=10, emitted=2,
                        next_tok=chains[1][1][-1])
    nb, fb = te.masked_decode_step(bad)
    assert fb[:3].all() and nb[1] == nc[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompts_decode_as_after_chunked_prefill(arch):
    """Prompts of 1 and 2 tokens, shorter than the conv's W-1 = 3 rows: the
    port's prefill leaves the zero-padded tail chunked prefill carries, so
    prefill + decode gives the logits of the JAX engine's chunked prefill +
    decode of the same prompt (the JAX package's own prefill returns a
    shorter tail here)."""
    je, te = pair(arch)
    for s in (1, 2):
        p = prompts(8 + s, (2, s))
        jc = jax_init_params(jax_cache_defs(je.cfg, batch=2, max_len=je.capacity),
                             jax.random.PRNGKey(0))
        jl, jc = je._chunk(je.params, jc, jnp.asarray(p), jnp.int32(0), None)
        with torch.inference_mode():
            tl, tc = prefill(te.params, as_tokens(p), te.cfg)
        close(tl, jl)
        assert tc["conv"].shape[2] == te.cfg.ssm.conv_width - 1
        tc = grow_cache(te.cfg, tc, te.capacity)
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
        for j in range(3):
            jl, jc = je._decode(je.params, jc, jnp.asarray(nxt), jnp.int32(s + j))
            with torch.inference_mode():
                tl, tc = decode_step(te.params, tc, as_tokens(nxt), s + j, te.cfg)
            close(tl, jl)
            nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
        assert te.generate(p, 3).shape == (2, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_projection_is_one_int8_matmul_call(arch, monkeypatch):
    """int8_matmul calls a model call makes: 3 a Mamba2 layer (wz, wx, wo;
    wB, wC and wdt are plain products), 9 a shared-block application (w_in,
    wq, wk, wv, wo, wg, wu, wd, w_out).  These are the counts chip_smoke.py
    holds the card's launch counters to."""
    _, te = pair(arch, "int8")
    calls = []
    real = tquant.int8_matmul
    monkeypatch.setattr(tquant, "int8_matmul", lambda *a: calls.append(a[0].shape[0]) or
                        real(*a))
    cfg = te.cfg
    with torch.inference_mode():
        _, cache = prefill(te.params, as_tokens(prompts(6)), cfg)
        n_prefill = len(calls)
        cache = grow_cache(cfg, cache, te.capacity)
        decode_step(te.params, cache, as_tokens(prompts(7, (2, 1))), S0, cfg)
        n_decode = len(calls) - n_prefill
        decode_verify(te.params, cache, as_tokens(prompts(8, (2, 3))), S0 + 1, cfg)
        n_verify = len(calls) - n_prefill - n_decode
    apps = len(_hybrid_segments(cfg)) if cfg.family == "hybrid" else 0
    assert (n_prefill, n_decode, n_verify) == (3 * cfg.num_layers + 9 * apps,) * 3
    assert set(calls[n_prefill:n_prefill + n_decode]) == {2}  # M = batch at decode


@pytest.mark.parametrize("arch", ARCHS)
def test_init_keeps_the_ssm_leaves_f32_and_their_small_products_unquantized(arch):
    """``init_model(quantize=True)`` draws the numbers of the full-precision
    model and quantizes only the projections: A_log, dt_bias and D stay f32
    in a bf16 model, wB/wC/wdt stay bf16; hybrid's shared block is quantized
    as it is drawn, as ``quantize_params`` would.  bf16 JAX weights carried
    over keep the same types."""
    cfg = torch_config(arch)
    full = init_model(cfg, torch.Generator().manual_seed(5), "cpu")
    quant = init_model(cfg, torch.Generator().manual_seed(5), "cpu", quantize=True)
    want = tquant.quantize_params(full, cfg)
    for p in (quant, want):
        m = p["blocks"]["mamba"]
        assert {k: m[k].dtype for k in ("A_log", "dt_bias", "D")} == dict.fromkeys(
            ("A_log", "dt_bias", "D"), torch.float32)
        assert all(m[k].dtype == torch.bfloat16 for k in ("wB", "wC", "wdt", "conv_x"))
        assert {k for k, v in m.items() if isinstance(v, tquant.QuantTensor)} == \
            {"wz", "wx", "wo"}
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return list(tree) if isinstance(tree, tquant.QuantTensor) else [tree]

    assert all(torch.equal(a, b) for a, b in zip(leaves(quant), leaves(want), strict=True))
    jcfg = jax_config(arch)
    defs = jax_param_defs(jcfg)
    jb = jax.tree.map(lambda d, a: a.astype(d.dtype), defs,
                      numpy_params(defs, np.random.default_rng(1)),
                      is_leaf=lambda d: hasattr(d, "logical"))
    tb = params_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    assert tb["blocks"]["mamba"]["A_log"].dtype == torch.float32
    assert tb["blocks"]["mamba"]["wB"].dtype == torch.bfloat16
