"""Speculative verify of the port against the JAX package, in f32 on the CPU:
``decode_verify`` at ragged per-row positions against JAX's called slot by
slot, and ``masked_speculative_step`` with oracle and always-wrong drafts
against the JAX engine (``tests/test_speculative.py``'s accept-all /
accept-0 case), with and without int8 weights.

Logits and caches agree to 1e-4 of their largest magnitude in f32 and to the
int8 rule of ``test_torch_chunked_prefill`` with int8 weights; tokens,
``accepted``, ``finite`` and the pools' ``committed`` / ``drafted`` are
identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import decode_verify as jax_decode_verify
from repro.models.params import init_params as jax_init_params
from repro.serving.kv_cache import cache_defs as jax_cache_defs
from repro_torch.models.model import decode_verify

from test_torch_chunked_prefill import agree
from test_torch_dense_serving import DENSE, engines

torch.set_num_threads(1)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_verify_at_ragged_positions_matches_jax_per_slot(arch, quant):
    """Three rows whose committed prefixes end at 3, 9 and 6 score windows of
    K + 1 = 4 tokens in one batched call; JAX scores each row alone at its
    own scalar position, on the same cache."""
    je, te = engines(arch, quant=quant, max_len=24, spec_slack=3)
    rng = np.random.default_rng(21)
    lens = (3, 9, 6)
    # the same prefilled cache for both: JAX prefills each row, the port
    # takes its bytes
    cache = jax_init_params(jax_cache_defs(je.cfg, batch=len(lens), max_len=je.capacity),
                            jax.random.PRNGKey(0))
    cache = {k: np.array(v) for k, v in cache.items()}
    for b, n in enumerate(lens):
        row = {k: jnp.asarray(v[:, b:b + 1]) for k, v in cache.items()}
        prompt = rng.integers(0, te.cfg.vocab_size, (1, n)).astype(np.int32)
        _, row = je._chunk(je.params, row, jnp.asarray(prompt), jnp.int32(0), None)
        for k in cache:
            cache[k][:, b:b + 1] = np.asarray(row[k])
    tokens = rng.integers(0, te.cfg.vocab_size, (len(lens), 4)).astype(np.int32)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.inference_mode():
        tl, tcache = decode_verify(te.params, tcache, torch.as_tensor(tokens.astype(np.int64)),
                                   torch.as_tensor(lens), te.cfg)
    assert tuple(tl.shape) == (3, 4, te.cfg.padded_vocab)
    for b, n in enumerate(lens):
        row = {k: jnp.asarray(v[:, b:b + 1]) for k, v in cache.items()}
        jl, row = jax_decode_verify(je.params, row, jnp.asarray(tokens[b:b + 1]), jnp.int32(n),
                                    je.cfg)
        agree(tl[b:b + 1], jl, quant)
        for k in cache:
            agree(tcache[k][:, b:b + 1], row[k], quant)


def greedy_ref(je, prompt, n):
    return je.generate(prompt[None], n)[0].tolist()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_verify_accept_all_and_accept_0_match_jax_engine(quant):
    """Oracle drafts accept all K (the bonus token extends the chain);
    always-wrong drafts accept 0 and still commit the plain-decode token
    each tick.  Both slots reproduce plain greedy decode, tick for tick the
    JAX engine's outputs, with its ``committed`` and ``drafted``."""
    je, te = engines("granite-3-8b", quant=quant, max_batch=2, max_len=48, spec_slack=3)
    prompt = np.random.default_rng(0).integers(0, te.cfg.vocab_size, 6).astype(np.int32)
    ref = greedy_ref(je, prompt, 8)
    assert te.generate(prompt[None], 8)[0].tolist() == ref
    jpool, tpool = je.make_pool(), te.make_pool()
    for slot in (0, 1):
        assert te.prefill_into_slot(tpool, slot, prompt, rid=slot, budget=8) == \
            je.prefill_into_slot(jpool, slot, prompt, rid=slot, budget=8) == ref[0]
    t_good, t_bad = [ref[0]], [ref[0]]
    ticks = 0
    while len(t_bad) < 8:
        drafts = np.zeros((2, 3), np.int32)
        i = len(t_good)
        drafts[0] = (ref[i:i + 3] + [0] * 3)[:3]                       # oracle
        drafts[1] = [(t + 1) % te.cfg.vocab_size                        # always wrong
                     for t in (ref[len(t_bad):len(t_bad) + 3] + [0] * 3)[:3]]
        out, acc, fin = te.masked_speculative_step(tpool, drafts)
        jout, jacc, jfin = je.masked_speculative_step(jpool, drafts)
        live = tpool.decode_mask()
        np.testing.assert_array_equal(out[live], jout[live])
        np.testing.assert_array_equal(acc[live], jacc[live])
        np.testing.assert_array_equal(fin, jfin)
        assert out.dtype == np.int32 and acc.dtype == np.int32 and fin.all()
        ticks += 1
        assert acc[1] == 0
        if len(t_good) < 8:
            n = min(int(acc[0]) + 1, 8 - len(t_good))
            t_good.extend(out[0, :n].tolist())
            for pool in (tpool, jpool):
                pool.advance(0, n, int(out[0, n - 1]))
        t_bad.append(int(out[1, 0]))
        for pool in (tpool, jpool):
            pool.advance(1, 1, int(out[1, 0]))
    assert t_good == ref and t_bad == ref
    assert ticks == 7
    assert (tpool.committed, tpool.drafted) == (jpool.committed, jpool.drafted) == (14, 5)


def test_verify_masks_admitting_and_free_slots_as_jax():
    """A pool with a decoding slot, an admitting slot (its chunked prefill in
    flight) and a free one: only the decoding slot's window counts, and its
    outputs are the JAX engine's."""
    je, te = engines("granite-3-8b", max_batch=3, max_len=32, spec_slack=2)
    rng = np.random.default_rng(22)
    jpool, tpool = je.make_pool(), te.make_pool()
    p = rng.integers(0, te.cfg.vocab_size, 7).astype(np.int32)
    assert te.prefill_into_slot(tpool, 2, p, rid=0, budget=6) == \
        je.prefill_into_slot(jpool, 2, p, rid=0, budget=6)
    group = rng.integers(0, te.cfg.vocab_size, (1, 5)).astype(np.int32)
    jst = je.begin_chunked_prefill(jpool, [0], group, rids=[1], budgets=[4])
    tst = te.begin_chunked_prefill(tpool, [0], group, rids=[1], budgets=[4])
    te.chunked_prefill_step(tst, 3)
    je.chunked_prefill_step(jst, 3)
    drafts = rng.integers(0, te.cfg.vocab_size, (3, 2)).astype(np.int32)
    np.testing.assert_array_equal(tpool.decode_mask(), [False, False, True])
    out, acc, fin = te.masked_speculative_step(tpool, drafts)
    jout, jacc, jfin = je.masked_speculative_step(jpool, drafts)
    np.testing.assert_array_equal(out[2], jout[2])
    assert acc[2] == jacc[2] and fin[2] and jfin[2]
