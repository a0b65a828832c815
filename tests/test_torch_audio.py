"""The audio family (whisper) of the port against the JAX package, on the CPU
at the reduced whisper-tiny config, in f32 with and without int8 weights:
the sinusoid table, attention without a mask over more keys than queries,
the cross-attention pieces (``_cross_kv``, ``gqa_cross_apply``), the encoder
block and every decoder body, then the model's entry points (``forward``,
``prefill`` with its four cache leaves, ``decode_step``, ``prefill_chunk``,
``decode_verify`` + ``commit_verify``, ``encoder_cross_cache``) and the
int8 projections one ``int8_matmul`` call each.

The frames are random (numpy, std 1), not the engine's zero stub, so that
the encoder's output depends on its weights; the token embedding is drawn
at std 1 in place of 0.02, so that the decoder's output depends on the
tokens and not on the sinusoid alone.  f32 is held to 2e-5 of the largest
magnitude (``close``), but for ``forward``'s hidden states, held to the
port's model-level f32 rule, 1e-4 (``test_torch_dense_serving.TOL``): they
read 3.0e-5 here.  The two frameworks' tanh and exp differ in the last bits
(XLA's CPU tanh is 2.4e-7 off the float64 value, torch's 3e-8), and under the
reference's fan-in rule for 3-D weights (``shape[-2]``, the head count) the
attention rows are nearly one-hot and the residual reaches 64, so two
decoder layers carry those bits to 3e-5 of the normed output; the logits,
caches and single blocks stay within 2.2e-5.  int8 is held to the int8 rule
of ``test_torch_chunked_prefill`` (max 0.1, mean 0.02 of the largest
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
from repro.models import layers as jlayers
from repro.models import quant as jquant
from repro.models import transformer as jT
from repro.models.model import commit_verify as jax_commit_verify
from repro.models.model import decode_verify as _jax_decode_verify
from repro.models.model import encoder_cross_cache as _jax_encoder_cross_cache
from repro.models.model import decode_step as _jax_decode_step
from repro.models.model import forward as _jax_forward
from repro.models.model import prefill as _jax_prefill
from repro.models.model import prefill_chunk as _jax_prefill_chunk
from repro.models.model import param_defs as jax_param_defs
from repro.models.params import init_params as jax_init_params
from repro.serving.kv_cache import cache_defs as jax_cache_defs
from repro_torch.configs import get_config, get_reduced_config as torch_config
from repro_torch.models import layers as tlayers
from repro_torch.models import quant as tquant
from repro_torch.models import transformer as tT
from repro_torch.models.model import (
    commit_verify, decode_step, decode_verify, encoder_cross_cache, forward, param_defs, prefill,
    prefill_chunk,
)
from repro_torch.models.params import init_params, params_from_numpy, tree_map
from repro_torch.models.quant import layer_of
from repro_torch.serving.kv_cache import cache_defs

from test_torch_chunked_prefill import close_q8
from test_torch_moe import jax_quantize_weight, numpy_params

torch.set_num_threads(1)
ARCH = "whisper-tiny"
QUANTS = (None, "int8")
TOL = 2e-5
MODEL_TOL = 1e-4  # forward's hidden states: see the module docstring
S0, CAP = 7, 16  # prompt length; cache rows of the chunk, decode and verify caches
jax_forward = jax.jit(_jax_forward, static_argnums=2)
jax_prefill = jax.jit(_jax_prefill, static_argnums=2)
jax_decode = jax.jit(_jax_decode_step, static_argnums=4)
jax_chunk = jax.jit(_jax_prefill_chunk, static_argnums=4)
jax_decode_verify = jax.jit(_jax_decode_verify, static_argnums=4)
jax_cross_cache = jax.jit(_jax_encoder_cross_cache, static_argnums=1)


def close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def agree(got, want, quant):
    (close if quant is None else close_q8)(got, want)


@functools.lru_cache(maxsize=None)
def weights(quant=None):
    """(JAX config, JAX params; port config, port params) over the same f32
    weights (the same for both ``quant``), the token embedding at std 1."""
    jcfg = dataclasses.replace(jax_config(ARCH), dtype=jnp.float32, quant=quant)
    tcfg = dataclasses.replace(torch_config(ARCH), dtype=torch.float32, quant=quant)
    jp = numpy_params(jax_param_defs(jcfg), np.random.default_rng(0))
    jp["embed"]["tokens"] = jp["embed"]["tokens"] * 50.0
    if quant:
        with mock.patch.object(jquant, "_quantize_weight", jax_quantize_weight):
            jp = jquant.quantize_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def frames(seed: int, batch: int = 2) -> np.ndarray:
    cfg = torch_config(ARCH)
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def prompts(seed: int, shape=(2, S0)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def as_tokens(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def jax_layer(jp, i: int = 0):
    return jax.tree.map(lambda t: t[i], jp)


def torch_layer(tp, i: int = 0):
    return tree_map(lambda t: layer_of(t, i), tp)


def test_configs_are_the_reference_field_for_field():
    def fields(cfg):
        return {f.name: str(getattr(cfg, f.name)).replace("torch.", "").replace(
            "<class 'jax.numpy.", "").replace("'>", "") for f in dataclasses.fields(cfg)}

    assert fields(get_config(ARCH)) == fields(jax_get_config(ARCH))
    assert fields(torch_config(ARCH)) == fields(jax_config(ARCH))
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.encoder_layers, full.d_model, full.num_heads,
            full.d_ff, full.vocab_size, full.encoder_seq, full.frontend) == \
        ("audio", 4, 4, 384, 6, 1536, 51865, 1500, "audio")


def test_param_defs_match_the_reference():
    """Leaf for leaf the JAX package's shapes: the encoder stack, its norm
    (LayerNorm's scale and bias), the decoder stack with its cross-attention
    and the classic two-matrix GELU MLP."""
    for get_t, get_j in ((get_config, jax_get_config), (torch_config, jax_config)):
        tdefs, jdefs = param_defs(get_t(ARCH)), jax_param_defs(get_j(ARCH))
        flat = {}

        def walk(prefix, t, j):
            if isinstance(t, dict):
                assert set(t) == set(j), prefix
                for k in t:
                    walk(f"{prefix}/{k}", t[k], j[k])
            else:
                flat[prefix] = t.shape
                assert t.shape == j.shape and t.logical == j.logical, prefix

        walk("", tdefs, jdefs)
    assert {"/enc_norm/bias", "/blocks/cross_attn/bk", "/blocks/mlp/bi"} <= set(flat)


@pytest.mark.parametrize("offset", [0, 5, 40])
def test_sinusoid_positions_at_an_int_offset_match_jax(offset):
    close(tT.sinusoid_positions(9, 64, offset), jT.sinusoid_positions(9, 64, offset))


def test_sinusoid_positions_at_per_row_offsets_match_jax_row_by_row():
    pos = torch.tensor([0, 3, 17, 60])
    table = tT.sinusoid_positions(5, 64, pos)
    assert tuple(table.shape) == (4, 5, 64) and table.dtype == torch.float32
    for b, p in enumerate(pos.tolist()):
        close(table[b], jT.sinusoid_positions(5, 64, p))
        assert torch.equal(table[b], tT.sinusoid_positions(5, 64, p))


def test_sinusoid_positions_at_whisper_full_width_match_jax():
    """The full config's encoder table, 1500 frames of 384 columns: within
    2e-5 of JAX's over the first 256 positions; past them the angle (up to
    1500 rad) carries its factor's last bit, and the factors are exp() of
    the same f32 products, where XLA's CPU exp is not correctly rounded (21
    of the 192 factors one ulp off the float64 value rounded; torch's: 1).
    One ulp of a factor, times 1500 rad, is 1.2e-4: the bound is 2e-4."""
    got = tT.sinusoid_positions(1500, 384).numpy()
    want = np.asarray(jT.sinusoid_positions(1500, 384))
    close(torch.from_numpy(got[:256]), want[:256])
    assert np.abs(got - want).max() < 2e-4


@pytest.mark.parametrize("sq,sk", [(3, 37), (1, 32), (5, 5)])
def test_attention_naive_without_a_mask_over_more_keys_matches_jax(sq, sk):
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    got = tlayers.attention_naive(*map(torch.from_numpy, (q, k, v)), causal=False)
    close(got, jlayers.attention_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=False))


def encoder_output(seed: int = 1):
    """A stand-in encoder output (B, encoder_seq, D), LayerNorm-sized."""
    return frames(seed)


@pytest.mark.parametrize("quant", QUANTS)
def test_cross_kv_and_gqa_cross_apply_match_jax(quant):
    jcfg, jp, tcfg, tp = weights(quant)
    jx, tx = jax_layer(jp["blocks"])["cross_attn"], torch_layer(tp["blocks"])["cross_attn"]
    enc = encoder_output()
    x = np.random.default_rng(2).standard_normal((2, S0, tcfg.d_model)).astype(np.float32)
    jkv = jax.jit(jT._cross_kv, static_argnums=2)(jx, jnp.asarray(enc), jcfg)
    with torch.inference_mode():
        tkv = tT._cross_kv(tx, torch.from_numpy(enc), tcfg)
        tout = tlayers.gqa_cross_apply(tx, torch.from_numpy(x), tkv, tcfg)
    for t, j in zip(tkv, jkv):
        assert tuple(t.shape) == (2, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.resolved_head_dim)
        agree(t, j, quant)
    jout = jax.jit(jlayers.gqa_cross_apply, static_argnums=3)(jx, jnp.asarray(x), jkv, jcfg)
    agree(tout, jout, quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_enc_block_apply_matches_jax(quant):
    jcfg, jp, tcfg, tp = weights(quant)
    x = frames(3)
    jy, _ = jax.jit(jT.enc_block_apply, static_argnums=2)(jax_layer(jp["enc_blocks"], 1),
                                                          jnp.asarray(x), jcfg)
    with torch.inference_mode():
        ty, aux = tT.enc_block_apply(torch_layer(tp["enc_blocks"], 1), torch.from_numpy(x), tcfg)
    agree(ty, jy, quant)
    assert float(aux) == 0.0


def _dec_inputs(tcfg):
    x = np.random.default_rng(4).standard_normal((2, S0, tcfg.d_model)).astype(np.float32)
    return x, encoder_output(5)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("body", ["apply", "prefill"])
def test_dec_block_apply_and_prefill_match_jax(body, quant):
    jcfg, jp, tcfg, tp = weights(quant)
    x, enc = _dec_inputs(tcfg)
    jfn = {"apply": jT.dec_block_apply, "prefill": jT.dec_block_prefill}[body]
    tfn = {"apply": tT.dec_block_apply, "prefill": tT.dec_block_prefill}[body]
    jy, jextra = jax.jit(jfn, static_argnums=3)(jax_layer(jp["blocks"], 1), jnp.asarray(x),
                                                jnp.asarray(enc), jcfg)
    with torch.inference_mode():
        ty, textra = tfn(torch_layer(tp["blocks"], 1), torch.from_numpy(x),
                         torch.from_numpy(enc), tcfg)
    agree(ty, jy, quant)
    if body == "prefill":  # (k, v, cross_k, cross_v)
        assert len(textra) == 4
        for t, j in zip(textra, jextra):
            agree(t, j, quant)


def _filled_cache(jcfg, jp, tcfg, tp, batch=2):
    """A decoder layer's (k, v, cross_k, cross_v) at CAP rows, the first S0
    written by the JAX package's prefill of random frames; the same bytes in
    both."""
    p, fe = prompts(6, (batch, S0)), frames(7, batch)
    _, jc = jax_prefill(jp, jnp.asarray(p), jcfg, jnp.asarray(fe))
    leaves = []
    for key in ("k", "v"):
        a = np.zeros((batch, CAP) + jc[key].shape[3:], np.float32)
        a[:, :S0] = np.asarray(jc[key][0])
        leaves.append(a)
    leaves += [np.asarray(jc[key][0]) for key in ("cross_k", "cross_v")]
    return leaves


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("body", ["chunk", "decode"])
def test_dec_block_chunk_and_decode_match_jax(body, quant):
    """One decoder layer at position S0 (a chunk of 3, or one token) over a
    cache the same in both; the chunk's self-attention K/V written at S0,
    the cross K/V left as they were."""
    jcfg, jp, tcfg, tp = weights(quant)
    leaves = _filled_cache(jcfg, jp, tcfg, tp)
    t = 3 if body == "chunk" else 1
    x = np.random.default_rng(8).standard_normal((2, t, tcfg.d_model)).astype(np.float32)
    jfn = {"chunk": jT.dec_block_chunk, "decode": jT.dec_block_decode}[body]
    tfn = {"chunk": tT.dec_block_chunk, "decode": tT.dec_block_decode}[body]
    jy, jcache = jax.jit(jfn, static_argnums=4)(
        jax_layer(jp["blocks"]), jnp.asarray(x), tuple(map(jnp.asarray, leaves)),
        jnp.int32(S0), jcfg)
    tcache = tuple(torch.from_numpy(a.copy()) for a in leaves)
    with torch.inference_mode():
        ty, out = tfn(torch_layer(tp["blocks"]), torch.from_numpy(x), tcache,
                      torch.full((2,), S0), tcfg)
    agree(ty, jy, quant)
    for got, want, before in zip(out, jcache, leaves):
        agree(got, want, quant)
    assert all(o is c for o, c in zip(out, tcache))  # written in place
    for i in (2, 3):
        assert np.array_equal(tcache[i].numpy(), leaves[i])


@pytest.mark.parametrize("quant", QUANTS)
def test_forward_matches_jax(quant):
    jcfg, jp, tcfg, tp = weights(quant)
    p, fe = prompts(9), frames(10)
    jh, _ = jax_forward(jp, jnp.asarray(p), jcfg, jnp.asarray(fe))
    with torch.inference_mode():
        th, aux = forward(tp, as_tokens(p), tcfg, torch.from_numpy(fe))
    if quant is None:
        close(th, jh, tol=MODEL_TOL)
    else:
        close_q8(th, jh)
    assert float(aux) == 0.0


@pytest.mark.parametrize("quant", QUANTS)
def test_prefill_logits_and_all_four_cache_leaves_match_jax(quant):
    jcfg, jp, tcfg, tp = weights(quant)
    p, fe = prompts(11), frames(12)
    jl, jc = jax_prefill(jp, jnp.asarray(p), jcfg, jnp.asarray(fe))
    with torch.inference_mode():
        tl, tc = prefill(tp, as_tokens(p), tcfg, frontend_embeds=torch.from_numpy(fe))
    agree(tl, jl, quant)
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    L, kv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    assert tuple(tc["k"].shape) == (L, 2, S0, kv, hd)
    assert tuple(tc["cross_k"].shape) == (L, 2, tcfg.encoder_seq, kv, hd)
    for key in tc:
        agree(tc[key], jc[key], quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_encoder_cross_cache_is_prefills_cross_leaves_bit_for_bit_and_jaxs(quant):
    """``encoder_cross_cache`` and ``prefill`` share the encoder pass: the
    same bits, whatever the prompt; and both are JAX's."""
    jcfg, jp, tcfg, tp = weights(quant)
    fe = frames(13)
    with torch.inference_mode():
        ck, cv = encoder_cross_cache(tp, tcfg, torch.from_numpy(fe))
        _, tc = prefill(tp, as_tokens(prompts(14)), tcfg, frontend_embeds=torch.from_numpy(fe))
    assert torch.equal(ck, tc["cross_k"]) and torch.equal(cv, tc["cross_v"])
    jk, jv = jax_cross_cache(jp, jcfg, jnp.asarray(fe))
    agree(ck, jk, quant)
    agree(cv, jv, quant)


def _grown(jc, jcfg):
    """JAX's prefill cache with its k/v grown to CAP rows."""
    out = dict(jc)
    for key in ("k", "v"):
        a = np.asarray(jc[key])
        pad = np.zeros(a.shape[:2] + (CAP - a.shape[2],) + a.shape[3:], a.dtype)
        out[key] = jnp.asarray(np.concatenate([a, pad], axis=2))
    return out


@pytest.mark.parametrize("quant", QUANTS)
def test_decode_steps_match_jax_and_leave_the_cross_leaves_alone(quant):
    jcfg, jp, tcfg, tp = weights(quant)
    p, fe = prompts(15), frames(16)
    jl, jc = jax_prefill(jp, jnp.asarray(p), jcfg, jnp.asarray(fe))
    jc = _grown(jc, jcfg)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    cross = {k: tc[k].clone() for k in ("cross_k", "cross_v")}
    nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
    for j in range(3):
        jl, jc = jax_decode(jp, jc, jnp.asarray(nxt), jnp.int32(S0 + j), jcfg)
        with torch.inference_mode():
            tl, tc = decode_step(tp, tc, as_tokens(nxt), S0 + j, tcfg)
        agree(tl, jl, quant)
        for key in tc:
            agree(tc[key], jc[key], quant)
        nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
    for key, t in cross.items():
        assert torch.equal(tc[key], t)


@pytest.mark.parametrize("quant", QUANTS)
def test_prefill_chunk_composes_to_prefill_from_the_encoder_cross_cache(quant):
    """The chunked composition: a zeroed cache, its cross K/V filled by
    ``encoder_cross_cache``, then chunks of 3 tokens; the last chunk's
    logits and every leaf are blocking prefill's (within the port) and
    JAX's chunked ones (across)."""
    jcfg, jp, tcfg, tp = weights(quant)
    p, fe = prompts(17), frames(18)
    with torch.inference_mode():
        tl_block, tc_block = prefill(tp, as_tokens(p), tcfg, frontend_embeds=torch.from_numpy(fe))
        tc = init_params(cache_defs(tcfg, batch=2, max_len=CAP), torch.Generator(), "cpu")
        ck, cv = encoder_cross_cache(tp, tcfg, torch.from_numpy(fe))
        tc["cross_k"].copy_(ck)
        tc["cross_v"].copy_(cv)
    jc = jax_init_params(jax_cache_defs(jcfg, batch=2, max_len=CAP), jax.random.PRNGKey(0))
    jk, jv = jax_cross_cache(jp, jcfg, jnp.asarray(fe))
    jc = dict(jc, cross_k=jk, cross_v=jv)
    for pos in range(0, S0, 3):
        jl, jc = jax_chunk(jp, jc, jnp.asarray(p[:, pos:pos + 3]), jnp.int32(pos), jcfg)
        with torch.inference_mode():
            tl, tc = prefill_chunk(tp, tc, as_tokens(p[:, pos:pos + 3]), pos, tcfg)
        agree(tl, jl, quant)
    agree(tl, tl_block.numpy(), quant)
    for key in ("k", "v"):
        agree(tc[key][:, :, :S0], tc_block[key].numpy(), quant)
        agree(tc[key], jc[key], quant)
        assert not tc[key][:, :, S0:].any()  # rows past the prompt stay dead
    for key in ("cross_k", "cross_v"):
        assert torch.equal(tc[key], tc_block[key])


@pytest.mark.parametrize("quant", QUANTS)
def test_verify_is_the_decode_steps_and_needs_no_rollback(quant):
    """A window of 4 tokens scored in one pass is the 4 decode steps'
    logits (within the port) and JAX's verify (across); ``commit_verify``
    at any accepted counts returns the cache as it is: the rows of rejected
    tokens are dead, and nothing writes the cross K/V."""
    jcfg, jp, tcfg, tp = weights(quant)
    p, fe, window = prompts(19), frames(20), prompts(21, (2, 4))
    _, jc = jax_prefill(jp, jnp.asarray(p), jcfg, jnp.asarray(fe))
    jc = _grown(jc, jcfg)
    jv, jvc = jax_decode_verify(jp, jc, jnp.asarray(window), jnp.int32(S0), jcfg)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    dc = {k: v.clone() for k, v in tc.items()}
    with torch.inference_mode():
        tv, tvc = decode_verify(tp, tc, as_tokens(window), S0, tcfg)
        steps = []
        for j in range(4):
            lj, dc = decode_step(tp, dc, as_tokens(window[:, j:j + 1]), S0 + j, tcfg)
            steps.append(lj.numpy())
        committed = commit_verify(tvc, torch.tensor([0, 3]), tcfg)
    agree(tv, np.stack(steps, axis=1), quant)
    agree(tv, jv, quant)
    assert committed is tvc and set(committed) == set(tc)
    jcommit = jax_commit_verify(jvc, 2, jcfg)
    for key in committed:
        agree(committed[key], jcommit[key], quant)
        agree(committed[key], dc[key].numpy(), quant)


def test_each_projection_is_one_int8_matmul_call(monkeypatch):
    """int8_matmul calls a model call makes, at the batch's row counts: the
    encoder 6 a layer (wq, wk, wv, wo, wi, wo) at M = B x encoder_seq; the
    decoder at prefill 10 a layer (self wq, wk, wv, wo; cross wq, wk and wv
    over the encoder output, wo; wi, wo) and 8 at decode, chunk and verify
    (the cross wk/wv are the cache's).  These are the counts chip_smoke.py
    holds the card's launch counters to."""
    _, _, tcfg, tp = weights("int8")
    calls = []
    real = tquant.int8_matmul
    monkeypatch.setattr(tquant, "int8_matmul", lambda *a: calls.append(a[0].shape[0]) or
                        real(*a))
    enc_l, dec_l, es = tcfg.encoder_layers, tcfg.num_layers, tcfg.encoder_seq
    with torch.inference_mode():
        _, cache = prefill(tp, as_tokens(prompts(22)), tcfg,
                           frontend_embeds=torch.from_numpy(frames(23)))
        n = {"prefill": len(calls)}
        ck = encoder_cross_cache(tp, tcfg, torch.from_numpy(frames(23)))
        n["encoder_cross_cache"] = len(calls) - sum(n.values())
        cache = dict(cache, k=torch.cat([cache["k"], torch.zeros_like(cache["k"])], 2),
                     v=torch.cat([cache["v"], torch.zeros_like(cache["v"])], 2))
        decode_step(tp, cache, as_tokens(prompts(24, (2, 1))), S0, tcfg)
        n["decode_step"] = len(calls) - sum(n.values())
        prefill_chunk(tp, cache, as_tokens(prompts(25, (2, 3))), S0, tcfg)
        n["prefill_chunk"] = len(calls) - sum(n.values())
        decode_verify(tp, cache, as_tokens(prompts(26, (2, 3))), S0, tcfg)
        n["decode_verify"] = len(calls) - sum(n.values())
    assert n == {"prefill": 6 * enc_l + 10 * dec_l, "encoder_cross_cache": 6 * enc_l + 2 * dec_l,
                 "decode_step": 8 * dec_l, "prefill_chunk": 8 * dec_l, "decode_verify": 8 * dec_l}
    assert calls[:6 * enc_l] == [2 * es] * 6 * enc_l  # the encoder: M = B x encoder_seq
    assert len(ck) == 2 and tuple(ck[0].shape[:3]) == (dec_l, 2, es)


def test_init_model_quantizes_every_projection_and_keeps_the_rest():
    """``init_model(quantize=True)`` is the full-precision draw, quantized:
    the encoder's, self- and cross-attention and MLP projections become
    QuantTensors, the biases and LayerNorms stay as drawn."""
    from repro_torch.models.model import init_model

    cfg = torch_config(ARCH)
    full = init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    quant = init_model(cfg, torch.Generator().manual_seed(3), "cpu", quantize=True)
    want = tquant.quantize_params(full, cfg)
    qt = tquant.QuantTensor
    for stack, attns in (("enc_blocks", ("attn",)), ("blocks", ("self_attn", "cross_attn"))):
        for a in attns:
            assert {k for k, v in quant[stack][a].items() if isinstance(v, qt)} == \
                {"wq", "wk", "wv", "wo"}
            assert quant[stack][a]["bq"].dtype == torch.bfloat16
        assert {k for k, v in quant[stack]["mlp"].items() if isinstance(v, qt)} == {"wi", "wo"}

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return list(tree) if isinstance(tree, qt) else [tree]

    assert all(torch.equal(a, b) for a, b in zip(leaves(quant), leaves(want), strict=True))
