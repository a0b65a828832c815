"""The port's int8-weight serving path (``quant="int8"``) against the JAX
engine's, in f32 on the CPU, for each reduced dense config.

Both quantize the same weights to the same bytes and contract them exactly,
so the two differ only where the f32 arithmetic before a projection differs
in its last bits, and that can move one activation across a rounding edge
of its row quantization: one step of ``amax / 127``.  The logits are
therefore held to the f32 tolerance plus one such step at the logits' own
scale, ``max|logit| / 127``; the greedy tokens must be identical."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.models.model import prefill
from repro_torch.models.quant import QuantTensor

from test_torch_dense_serving import DENSE, TOL, check_masked_decode, engines

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", DENSE)
def test_int8_prefill_and_generate_match_jax(arch):
    je, te = engines(arch, quant="int8")
    assert isinstance(te.params["blocks"]["mlp"]["wi" if "wi" in te.params["blocks"]["mlp"]
                                               else "wg"], QuantTensor)
    prompts = np.random.default_rng(1).integers(0, te.cfg.vocab_size, (3, 7)).astype(np.int32)
    jl = np.asarray(je._prefill(je.params, jnp.asarray(prompts), None)[0])
    with torch.inference_mode():
        tlog = prefill(te.params, torch.as_tensor(prompts.astype(np.int64)), te.cfg)[0].numpy()
    scale = float(np.abs(jl).max())
    step = scale / 127.0
    np.testing.assert_allclose(tlog, jl, rtol=TOL, atol=TOL * max(1.0, scale) + step)
    np.testing.assert_array_equal(te.generate(prompts, 8), je.generate(prompts, 8))


def test_int8_masked_decode_step_matches_jax_engine():
    je, te = engines("granite-3-8b", quant="int8")
    check_masked_decode(je, te)


def test_each_quantized_projection_is_one_int8_matmul_call(monkeypatch):
    """7 projections per layer (wq, wk, wv, wo, wg, wu, wd) for SwiGLU and 6
    for the GELU MLP, per prefill and per decode call; on the CPU they take
    the plain version, so the launch counters stay at 0."""
    from repro_torch.models import quant

    calls = []
    real = quant.int8_matmul
    monkeypatch.setattr(quant, "int8_matmul", lambda *a: calls.append(a[0].shape) or real(*a))
    for arch, per_layer in (("granite-3-8b", 7), ("granite-34b", 6)):
        _, te = engines(arch, quant="int8")
        calls.clear()
        runtime.reset_launch_counts()
        te.generate(np.zeros((2, 5), np.int32), 3)
        assert len(calls) == per_layer * te.cfg.num_layers * 4  # prefill + 3 decode calls
        assert runtime.launch_counts() == {}
        assert calls[0] == (10, 64) and calls[-1] == (2, te.cfg.d_ff)


def test_full_and_quantized_engines_agree_on_greedy_chains():
    """The port's own int8 engine against its full-precision one on the same
    weights: the wiring floor of docs/kernels.md (agreement >= 0.3)."""
    _, full = engines("granite-3-8b")
    _, q8 = engines("granite-3-8b", quant="int8")
    prompts = np.random.default_rng(4).integers(0, 512, (4, 6)).astype(np.int32)
    agree = float((full.generate(prompts, 8) == q8.generate(prompts, 8)).mean())
    assert agree >= 0.3, agree
    assert dataclasses.replace(q8.cfg, quant=None) == full.cfg
