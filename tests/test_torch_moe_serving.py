"""The moe family served by the port against the JAX engine, on the CPU at
the reduced configs of granite-moe-3b-a800m (GQA attention + MoE) and
deepseek-v3-671b (MLA over the compressed cache; one MLA + dense-MLP layer,
then MLA + MoE layers with a shared expert), in f32 with and without int8
weights: ``forward`` (hidden states and the summed aux loss), prefill and
decode logits, ``generate``, the masked decode tick, chunked prefill against
blocking prefill and speculative verify against plain decode (within each
framework and across them: the identities ``tests/test_serving.py`` and
``tests/test_speculative.py`` assert inside JAX), ``cache_bytes``, and
``init_model(quantize=True)``.

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
from repro.models.model import decode_verify as _jax_decode_verify
from repro.models.model import forward as _jax_forward
from repro.models import quant as jquant
from repro.models.model import param_defs as jax_param_defs
from repro.models.params import init_params as jax_init_params
from repro.serving.kv_cache import cache_bytes as jax_cache_bytes
from repro.serving.kv_cache import cache_defs as jax_cache_defs
from repro.serving.engine import InferenceEngine as JaxEngine, ServeConfig as JaxServeConfig
from repro.serving.slots import grow_cache as jax_grow_cache
from repro_torch.configs import get_config, get_reduced_config as torch_config
from repro_torch.models import quant as tquant
from repro_torch.models.model import (
    decode_step, decode_verify, forward, init_model, prefill, prefill_chunk,
)
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serving.engine import InferenceEngine, ServeConfig
from repro_torch.serving.kv_cache import cache_bytes, cache_defs
from repro_torch.serving.slots import grow_cache

from test_torch_chunked_prefill import agree
from test_torch_dense_serving import close
from test_torch_moe import jax_quantize_weight, numpy_params

torch.set_num_threads(1)
ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b")
# the reference's functions under jax.jit, the config static: one compile a
# shape, where op by op compiles every operation of the model
jax_forward = jax.jit(_jax_forward, static_argnums=2)
jax_decode_verify = jax.jit(_jax_decode_verify, static_argnums=4)
QUANTS = (None, "int8")


@functools.lru_cache(maxsize=None)
def pair(arch: str, quant=None):
    """The JAX and the port engine over the same f32 weights (the same for
    both ``quant``), shared by the tests of this file (each makes its own
    pools and caches)."""
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32, quant=quant)
    tcfg = dataclasses.replace(torch_config(arch), dtype=torch.float32, quant=quant)
    jp = numpy_params(jax_param_defs(jcfg), np.random.default_rng(0))
    if quant:  # the reference's walk over the tree, each leaf by the numpy quantizer
        with mock.patch.object(jquant, "_quantize_weight", jax_quantize_weight):
            jp = jquant.quantize_params(jp, jcfg)  # the engine takes quantized leaves as they are
    je = JaxEngine(jcfg, params=jp, sc=JaxServeConfig(max_batch=4, max_len=32, spec_slack=3))
    te = InferenceEngine(tcfg, params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                         sc=ServeConfig(max_batch=4, max_len=32, spec_slack=3), device="cpu")
    return je, te


S0 = 7  # every prompt of this file: one shape, compiled once per JAX engine


def prompts(seed: int, shape=(2, S0), vocab: int = 512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def as_tokens(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def test_moe_configs_are_the_reference_field_for_field():
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


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_and_generate_match_jax(arch, quant):
    je, te = pair(arch, quant)
    p = prompts(1)
    jh, jaux = jax_forward(je.params, jnp.asarray(p), je.cfg)
    jl, jc = je._prefill(je.params, jnp.asarray(p), None)
    with torch.inference_mode():
        th, taux = forward(te.params, as_tokens(p), te.cfg)
        tl, tc = prefill(te.params, as_tokens(p), te.cfg)
    agree(th, jh, quant)
    close(taux, jaux)
    assert float(taux) > 0  # the MoE layers' load-balance loss, summed
    agree(tl, jl, quant)
    assert set(tc) == set(jc) == ({"c", "krope"} if te.cfg.mla else {"k", "v"})
    for key in tc:
        agree(tc[key], jc[key], quant)
    # one decode step on caches grown to capacity, every row at position S0
    jc = jax_grow_cache(je.cfg, jc, je.capacity)
    tc = grow_cache(te.cfg, tc, te.capacity)
    nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
    jl2, jc2 = je._decode(je.params, jc, jnp.asarray(nxt), jnp.int32(S0))
    with torch.inference_mode():
        tl2, tc2 = decode_step(te.params, tc, as_tokens(nxt), S0, te.cfg)
    agree(tl2, jl2, quant)
    for key in tc2:
        agree(tc2[key], jc2[key], quant)
    if quant is None:
        np.testing.assert_array_equal(te.generate(p, 6), je.generate(p, 6))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_masked_decode_step_matches_jax_engine(arch, quant):
    """Slots 0 and 2 admitted at tick 0, slot 3 at tick 1 (so the rows sit at
    ragged positions), slot 1 free: the same next tokens and finite flags as
    the JAX engine's vmapped masked step, tick after tick."""
    je, te = pair(arch, quant)
    p = prompts(2, (3, S0))
    jpool, tpool = je.make_pool(), te.make_pool()
    for tick in range(3):
        for slot, row in {0: {0: 0, 2: 1}, 1: {3: 2}}.get(tick, {}).items():
            assert te.prefill_into_slot(tpool, slot, p[row], rid=slot, budget=8) == \
                je.prefill_into_slot(jpool, slot, p[row], rid=slot, budget=8)
        live = tpool.decode_mask().copy()
        np.testing.assert_array_equal(live, jpool.decode_mask())
        tn, tf = te.masked_decode_step(tpool)
        jn, jf = je.masked_decode_step(jpool)
        np.testing.assert_array_equal(tn[live], jn[live])
        np.testing.assert_array_equal(tf[live], jf[live])
        assert tf[live].all()
        for slot in np.flatnonzero(live):
            tpool.advance(int(slot), 1, int(tn[slot]))
            jpool.advance(int(slot), 1, int(jn[slot]))
    np.testing.assert_array_equal(tpool.positions(), [S0 + 3, 0, S0 + 3, S0 + 2])


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_blocking_prefill_in_both_and_across(arch, quant):
    """Chunks of 3 tokens over a 7-token prompt: the last chunk's logits and
    the cache rows are blocking prefill's, in the port and in JAX, and the
    port's are JAX's."""
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
    agree(tl, np.asarray(tl_block), quant)              # within the port
    agree(torch.from_numpy(np.asarray(jl)), jl_block, quant)  # within JAX
    agree(tl, jl_block, quant)                          # across
    for key in tc:
        agree(tc[key][:, :, :S0], tc_block[key].numpy(), quant)
        agree(tc[key], jc[key], quant)
        assert not tc[key][:, :, S0:].any()  # rows past the prompt stay dead


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_equals_plain_decode_in_both_and_across(arch, quant):
    """A verify window of 4 tokens scores each position as 4 decode steps
    do, in the port and in JAX, and the port's window is JAX's; then the
    engines' speculative ticks with oracle and always-wrong drafts (accept
    0) agree with JAX's tick for tick."""
    je, te = pair(arch, quant)
    p = prompts(4)
    window = prompts(5, (2, 4))
    jl, jc = je._prefill(je.params, jnp.asarray(p), None)
    jc = jax_grow_cache(je.cfg, jc, je.capacity)
    with torch.inference_mode():
        _, tc = prefill(te.params, as_tokens(p), te.cfg)
        tc = grow_cache(te.cfg, tc, te.capacity)
        tv, _ = decode_verify(te.params, {k: v.clone() for k, v in tc.items()},
                              as_tokens(window), S0, te.cfg)
        steps = []
        for j in range(4):
            lj, tc = decode_step(te.params, tc, as_tokens(window[:, j:j + 1]), S0 + j, te.cfg)
            steps.append(lj)
    jv, _ = jax_decode_verify(je.params, jc, jnp.asarray(window), jnp.int32(S0), je.cfg)
    jsteps = []
    for j in range(4):
        lj, jc = je._decode(je.params, jc, jnp.asarray(window[:, j:j + 1]), jnp.int32(S0 + j))
        jsteps.append(np.asarray(lj))
    agree(tv, np.stack([s.numpy() for s in steps], axis=1), quant)   # within the port
    agree(torch.from_numpy(np.asarray(jv)), np.stack(jsteps, axis=1), quant)  # within JAX
    agree(tv, jv, quant)                                                # across

    # the engines' speculative ticks: slot 0 oracle drafts, slot 1 wrong ones.
    # Tokens are compared across the frameworks in f32 only: with int8
    # weights one flipped activation rounding can move a greedy token.
    ref = [int(np.argmax(np.asarray(jl)[0, :te.cfg.vocab_size]))]  # the plain greedy chain
    jrow = jax_grow_cache(je.cfg, je._prefill(je.params, jnp.asarray(p), None)[1], je.capacity)
    for j in range(6):
        lj, jrow = je._decode(je.params, jrow, jnp.asarray(np.full((2, 1), ref[-1], np.int32)),
                              jnp.int32(S0 + j))
        ref.append(int(np.argmax(np.asarray(lj)[0, :te.cfg.vocab_size])))
    jpool, tpool = je.make_pool(), te.make_pool()
    for slot in (0, 1):
        assert te.prefill_into_slot(tpool, slot, p[0], rid=slot, budget=7) == \
            je.prefill_into_slot(jpool, slot, p[0], rid=slot, budget=7)
    for _ in range(2):
        drafts = np.zeros((4, 3), np.int32)
        e0, e1 = tpool.slots[0].emitted, tpool.slots[1].emitted
        drafts[0] = (ref[e0:e0 + 3] + [0] * 3)[:3]
        drafts[1] = [(t + 1) % te.cfg.vocab_size for t in (ref[e1:e1 + 3] + [0] * 3)[:3]]
        out, acc, fin = te.masked_speculative_step(tpool, drafts)
        jout, jacc, jfin = je.masked_speculative_step(jpool, drafts)
        live = tpool.decode_mask()
        if quant is None:
            np.testing.assert_array_equal(out[live], jout[live])
            np.testing.assert_array_equal(acc[live], jacc[live])
        assert fin[live].all() and jfin[live].all() and acc[1] == jacc[1] == 0
        for pool, o, a in ((tpool, out, acc), (jpool, jout, jacc)):
            n0 = min(int(a[0]) + 1, 7 - pool.slots[0].emitted)
            pool.advance(0, n0, int(o[0, n0 - 1]))
            pool.advance(1, 1, int(o[1, 0]))


def test_cache_bytes_match_the_reference():
    for arch in ARCHS:
        for get_t, get_j in ((get_config, jax_get_config), (torch_config, jax_config)):
            assert cache_bytes(get_t(arch), batch=3, max_len=40) == \
                jax_cache_bytes(get_j(arch), batch=3, max_len=40)
    c = cache_defs(get_config("deepseek-v3-671b"), batch=2, max_len=16)
    assert c["c"].shape == (61, 2, 16, 512) and c["krope"].shape == (61, 2, 16, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_draws_the_same_numbers_with_and_without_quantization(arch):
    """Experts are quantized per expert, as ``quantize_params`` does: the
    expert axis is a lead axis, not a contraction axis."""
    cfg = dataclasses.replace(torch_config(arch), dtype=torch.float32)
    full = init_model(cfg, torch.Generator().manual_seed(5), "cpu")
    quant = init_model(cfg, torch.Generator().manual_seed(5), "cpu", quantize=True)
    want = tquant.quantize_params(full, cfg)
    n = 0

    def same(a, b):
        nonlocal n
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, tquant.QuantTensor):
            n += 1
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)

    stacks = [k for k in ("dense_blocks", "blocks") if k in full]
    for key in stacks:
        same(quant[key], want[key])
    assert torch.equal(quant["embed"]["tokens"], full["embed"]["tokens"])
    wg = quant["blocks"]["moe"]["wg"]
    assert wg.scale.shape == wg.q.shape[:2] + wg.q.shape[3:]  # (L, E, f): per expert
    # granite-moe: 4 attention + 3 experts; deepseek: 6 MLA + 3 MLP, 6 MLA + 3 + 3 shared
    assert n == (7 if cfg.mla is None else 9 + 12)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_expert_einsum_is_one_int8_matmul_call(arch, monkeypatch):
    """int8_matmul calls a model call makes: granite-moe 7 a layer (wq, wk,
    wv, wo and the three expert einsums, each over all experts at once);
    deepseek's MLA 4 at decode and chunk (wq_a, wq_b, wkv_a, wo; the
    absorbed wk_b and wv_b go through dequantize) and 6 at prefill (wk_b and
    wv_b decompress K/V), the dense MLP 3, the MoE 3 + 3 shared.  These are
    the counts chip_smoke.py holds the card's launch counters to."""
    _, te = pair(arch, "int8")
    calls = []
    real = tquant.int8_matmul
    monkeypatch.setattr(tquant, "int8_matmul", lambda *a: calls.append(a[0].dim()) or real(*a))
    cfg = te.cfg
    with torch.inference_mode():
        _, cache = prefill(te.params, as_tokens(prompts(6)), cfg)
        n_prefill = len(calls)
        cache = grow_cache(cfg, cache, te.capacity)
        decode_step(te.params, cache, as_tokens(prompts(7, (2, 1))), S0, cfg)
        n_decode = len(calls) - n_prefill
        decode_verify(te.params, cache, as_tokens(prompts(8, (2, 3))), S0 + 1, cfg)
        n_verify = len(calls) - n_prefill - n_decode
    if cfg.mla is None:
        want = (7 * cfg.num_layers,) * 3
        assert calls.count(3) == 3 * cfg.num_layers * 3  # the batched expert launches
    else:
        k, moe_layers = cfg.first_k_dense, cfg.num_layers - cfg.first_k_dense
        step = k * (4 + 3) + moe_layers * (4 + 3 + 3)
        want = (k * (6 + 3) + moe_layers * (6 + 3 + 3), step, step)
    assert (n_prefill, n_decode, n_verify) == want
