"""The port's dense serving path against the JAX engine, full precision, in
f32 on the CPU, for each reduced dense config: the same weights (JAX's,
carried over with ``params_from_numpy``) and the same prompts.

Logits agree to 1e-4 of their largest magnitude (the two frameworks round
the stack's f32 sums differently; the reduced models' logits are of order
1-10), and the greedy chains are identical for 8 steps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models.model import init_model as jax_init_model
from repro.serving.engine import InferenceEngine as JaxEngine, ServeConfig as JaxServeConfig
from repro.serving.slots import grow_cache as jax_grow_cache
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.models.model import decode_step, forward, prefill
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import InferenceEngine, ServeConfig
from repro_torch.serving.kv_cache import cache_bytes
from repro_torch.serving.slots import grow_cache

torch.set_num_threads(1)
DENSE = ("granite-3-8b", "granite-34b", "starcoder2-15b", "qwen1.5-110b")
TOL = 1e-4


def engines(arch: str, quant=None, max_batch: int = 4, max_len: int = 64, spec_slack: int = 0,
            **cfg_fields):
    """A JAX and a port engine over the same f32 weights.  Zero-initialised
    leaves (the biases) get small random values so that they count.
    ``cfg_fields`` replace fields of both configs (e.g. the vlm family)."""
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32, quant=quant, **cfg_fields)
    tcfg = dataclasses.replace(torch_config(arch), dtype=torch.float32, quant=quant,
                               **cfg_fields)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jax_init_model(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda a: a if bool(a.any()) else
                      a + jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1), jp)
    je = JaxEngine(jcfg, params=jp, sc=JaxServeConfig(max_batch=max_batch, max_len=max_len,
                                                      spec_slack=spec_slack))
    te = InferenceEngine(tcfg, params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                         sc=ServeConfig(max_batch=max_batch, max_len=max_len,
                                        spec_slack=spec_slack), device="cpu")
    return je, te


def close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_and_generate_match_jax(arch):
    je, te = engines(arch)
    prompts = np.random.default_rng(1).integers(0, te.cfg.vocab_size, (3, 7)).astype(np.int32)
    toks = torch.as_tensor(prompts.astype(np.int64))
    jl, jc = je._prefill(je.params, jnp.asarray(prompts), None)
    with torch.inference_mode():
        tlog, tc = prefill(te.params, toks, te.cfg)
    close(tlog, jl)
    close(tc["k"], jc["k"])
    # one decode step on caches grown to capacity, every row at position 7
    jc = jax_grow_cache(je.cfg, jc, je.capacity)
    tc = grow_cache(te.cfg, tc, te.capacity)
    nxt = np.argmax(np.asarray(jl), axis=-1)[:, None].astype(np.int32)
    jl2, _ = je._decode(je.params, jc, jnp.asarray(nxt), jnp.int32(7))
    with torch.inference_mode():
        tl2, _ = decode_step(te.params, tc, torch.as_tensor(nxt.astype(np.int64)), 7, te.cfg)
    close(tl2, jl2)
    np.testing.assert_array_equal(te.generate(prompts, 8), je.generate(prompts, 8))


def test_forward_hidden_matches_jax():
    from repro.models.model import forward as jax_forward

    je, te = engines("granite-3-8b")
    toks = np.random.default_rng(2).integers(0, 512, (2, 9)).astype(np.int32)
    jh, _ = jax_forward(je.params, jnp.asarray(toks), je.cfg)
    with torch.inference_mode():
        th, aux = forward(te.params, torch.as_tensor(toks.astype(np.int64)), te.cfg)
    close(th, jh)
    assert float(aux) == 0.0


def test_masked_decode_step_matches_jax_engine():
    """A pool with ragged slot positions and an inactive slot: the same next
    tokens and finite flags as the JAX engine's vmapped masked step, tick
    after tick, with a slot admitted after the first tick."""
    je, te = engines("granite-3-8b")
    check_masked_decode(je, te)


def check_masked_decode(je, te, ticks: int = 4):
    rng = np.random.default_rng(3)
    prompts = {0: 5, 2: 11, 3: 8}
    late = (1, 6)  # slot 1 is admitted after the first tick
    jpool, tpool = je.make_pool(), te.make_pool()
    for slot, n in prompts.items():
        p = rng.integers(0, te.cfg.vocab_size, n).astype(np.int32)
        assert te.prefill_into_slot(tpool, slot, p, rid=slot, budget=10) == \
            je.prefill_into_slot(jpool, slot, p, rid=slot, budget=10)
    for tick in range(ticks):
        if tick == 1:
            p = rng.integers(0, te.cfg.vocab_size, late[1]).astype(np.int32)
            assert te.prefill_into_slot(tpool, late[0], p, rid=9, budget=10) == \
                je.prefill_into_slot(jpool, late[0], p, rid=9, budget=10)
        live = tpool.decode_mask().copy()
        np.testing.assert_array_equal(live, jpool.decode_mask())
        tn, tf = te.masked_decode_step(tpool)
        jn, jf = je.masked_decode_step(jpool)
        np.testing.assert_array_equal(tn[live], jn[live])
        np.testing.assert_array_equal(tf[live], jf[live])
        assert tf[live].all()
        for s in np.flatnonzero(live):
            tpool.advance(int(s), 1, int(tn[s]))
            jpool.advance(int(s), 1, int(jn[s]))


def test_unported_options_raise():
    """Once refused until the scheduler was ported: ``ServeConfig.faults``
    and ``energy_budget_j`` now build, and a scheduler over the engine
    reads them (a fault profile injects, a budget bounds every window);
    sampling (``greedy=False``) is still refused, as in the JAX engine."""
    from repro_torch.serving.faults import FaultProfile
    from repro_torch.serving.load import poisson_stream
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler, FixedCalibration

    cfg = dataclasses.replace(torch_config("granite-3-8b"), dtype=torch.float32)
    prof = FaultProfile(seed=7, nan_rate=0.3, max_faults=3)
    eng = InferenceEngine(cfg, sc=ServeConfig(max_batch=2, max_len=32, faults=prof,
                                              energy_budget_j=60.0, budget_window_s=0.25),
                          device="cpu")
    assert eng.sc.faults is prof and eng.sc.energy_budget_j == 60.0
    sched = ContinuousBatchingScheduler(eng, policy="idle_waiting",
                                        calibration=FixedCalibration(step_s=0.004,
                                                                     prefill_per_tok_s=0.001))
    assert sched.faults is prof
    rep = sched.run(poisson_stream(4, rate_hz=40.0, seed=1, vocab_size=cfg.vocab_size,
                                   prompt_lens=(4,), new_tokens=(3, 6)))
    assert rep.quarantined > 0 and rep.failed == 0 and rep.items == 4
    assert 0.0 < rep.peak_budget_window_j <= 60.0 * (1 + 1e-9)
    with pytest.raises(NotImplementedError, match="greedy"):
        InferenceEngine(cfg, sc=ServeConfig(greedy=False), device="cpu")
    # the paged pool's options are ported (tests/test_torch_paged_serving.py)
    for opt in ({"paged": True}, {"paged": True, "kv_quant": "int8"},
                {"paged": True, "share_prefix": True}):
        InferenceEngine(cfg, sc=ServeConfig(max_batch=2, max_len=16, **opt), device="cpu")
    # every family of the JAX package is served now; a family it does not
    # have is refused
    with pytest.raises(ValueError, match="unknown family"):
        InferenceEngine(dataclasses.replace(cfg, family="speech"), device="cpu")


def test_spec_slack_is_accepted_and_a_verify_tick_runs():
    """``spec_slack`` (once refused as unported) sizes the pool's spare rows,
    and a verify tick over them gives the JAX engine's tokens."""
    je, te = engines("granite-3-8b", max_batch=2, max_len=32, spec_slack=2)
    assert te.capacity == 34
    jpool, tpool = je.make_pool(), te.make_pool()
    assert tpool.slack == 2 and tuple(tpool.cache["k"].shape[:3]) == (2, 2, 34)
    prompt = np.random.default_rng(4).integers(0, te.cfg.vocab_size, 5).astype(np.int32)
    for slot in (0, 1):
        assert te.prefill_into_slot(tpool, slot, prompt, rid=slot, budget=6) == \
            je.prefill_into_slot(jpool, slot, prompt, rid=slot, budget=6)
    drafts = np.asarray([[1, 2], [3, 4]], np.int32)
    for got, want in zip(te.masked_speculative_step(tpool, drafts),
                         je.masked_speculative_step(jpool, drafts)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="spec_slack"):
        te.masked_speculative_step(tpool, np.zeros((2, 3), np.int32))


def test_init_model_draws_the_same_weights_with_and_without_quantization():
    from repro_torch.models.model import init_model
    from repro_torch.models.quant import quantize_params

    cfg = dataclasses.replace(torch_config("granite-3-8b"), dtype=torch.float32)
    full = init_model(cfg, torch.Generator().manual_seed(5), "cpu")
    quant = init_model(cfg, torch.Generator().manual_seed(5), "cpu", quantize=True)
    want = quantize_params(full, cfg)
    for name in ("wq", "wo"):
        assert torch.equal(quant["blocks"]["attn"][name].q, want["blocks"]["attn"][name].q)
        assert torch.equal(quant["blocks"]["attn"][name].scale,
                           want["blocks"]["attn"][name].scale)
    assert torch.equal(quant["embed"]["tokens"], full["embed"]["tokens"])
    # stacked layers are drawn as one-layer slices, with the stacked fan-in
    wq = full["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 4, 16)
    assert 0.3 < float(wq.float().std()) < 0.7  # std 1/sqrt(4 heads), as the reference


def test_cache_bytes():
    from repro.serving.kv_cache import cache_bytes as jax_cache_bytes

    for arch in DENSE:
        assert cache_bytes(torch_config(arch), batch=3, max_len=40) == \
            jax_cache_bytes(jax_config(arch), batch=3, max_len=40)
