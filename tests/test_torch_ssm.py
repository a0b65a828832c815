"""The port's Mamba2 module (``models/ssm.py``) against the JAX package's, on
the CPU, from the same numpy inputs and weights: the SSD scan (two chunks,
the single-chunk fallback, a carried h0), the per-position snapshots, the
three conv forms, the five ``mamba_*`` block functions in f32 and with int8
weights, the verify commit at mixed accepted counts, and ``softplus``.

f32 results agree to 1e-4 of their largest magnitude; with int8 weights the
block outputs are held to the int8 rule of ``test_torch_chunked_prefill``
(max 0.1, mean 0.02 of the largest magnitude): an f32 last-bit difference
can move an activation across an edge of its int8 row quantization."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.models import ssm as tssm
from repro_torch.models.params import params_from_numpy

from test_torch_chunked_prefill import agree
from test_torch_dense_serving import close
from test_torch_moe import jax_quantize_weight, numpy_params

torch.set_num_threads(1)
B, H, P, N = 2, 3, 4, 5
QUANTS = (None, "int8")


def ssd_inputs(seed: int, s: int, h0: bool = False):
    """f32 numpy (x, dt, A, B, C[, h0]): dt after softplus, A negative."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((B, s, H, P)),
           np.log1p(np.exp(rng.standard_normal((B, s, H)))),
           -np.exp(rng.standard_normal(H) * 0.5),
           rng.standard_normal((B, s, N)), rng.standard_normal((B, s, N))]
    if h0:
        out.append(rng.standard_normal((B, H, P, N)))
    return [a.astype(np.float32) for a in out]


def t(a):
    """A tensor copy of ``a`` (the commit writes in place: never into the
    shared numpy inputs)."""
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("s, chunk, with_h0", [(64, 32, False), (64, 32, True), (40, 32, False),
                                               (40, 32, True)])
def test_ssd_chunked_matches_jax_and_the_sequential_oracle(s, chunk, with_h0):
    """S = 64 in two chunks of 32 (the inter-chunk scan), S = 40 (not a
    multiple: the single-chunk fallback), each from zeros and from a
    nonzero h0."""
    args = ssd_inputs(s + with_h0, s, with_h0)
    x, dt, a, bm, cm = args[:5]
    h0 = args[5] if with_h0 else None
    jy, jh = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, a, bm, cm)), chunk, None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), chunk,
                              None if h0 is None else t(h0))
    close(ty, jy)
    close(th, jh)
    ry, rh = tssm.ssm_reference(t(x), t(dt), t(a), t(bm), t(cm), None if h0 is None else t(h0))
    close(ty, ry.numpy())
    close(th, rh.numpy())


def test_ssd_states_and_the_state_at_each_rows_own_count():
    x, dt, a, bm, cm, h0 = ssd_inputs(3, 5, True)
    jy, jh = jax.jit(jssm.ssd_states)(*map(jnp.asarray, (x, dt, a, bm, cm, h0)))
    ty, th = tssm.ssd_states(t(x), t(dt), t(a), t(bm), t(cm), t(h0))
    close(ty, jy)
    close(th, jh)
    # the last snapshot is the chunked scan's final state, each y the oracle's
    ry, rh = tssm.ssm_reference(t(x), t(dt), t(a), t(bm), t(cm), t(h0))
    close(ty, ry.numpy())
    close(th[:, -1], rh.numpy())
    cum = torch.cumsum(t(dt) * t(a), dim=1)
    u = t(dt)[..., None] * t(x)
    for idx in ([0, 4], [2, 0], [4, 3], [1, 1]):
        got = tssm.ssd_state_at(cum, u, t(bm), t(h0), torch.tensor(idx))
        close(got, np.stack([np.asarray(jh)[b, i] for b, i in enumerate(idx)]))


def test_the_segment_matrix_has_no_nan_above_the_diagonal():
    """exp(cum_i - cum_j) overflows above the diagonal at long chunks; the
    masked entries must be 0, not inf * 0 = NaN."""
    cum = -torch.arange(64, dtype=torch.float32)[None, :, None] * 10.0
    seg = tssm._segments(cum)
    assert torch.isfinite(seg).all() and not seg.triu(1).any()


@pytest.mark.parametrize("form", ["causal", "chunk", "step"])
def test_conv_forms_match_jax(form):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal((B, 5 if form != "step" else 1, 6)).astype(np.float32)
    tail = rng.standard_normal((B, 3, 6)).astype(np.float32)
    if form == "causal":
        close(tssm._causal_conv(t(x), t(w), t(b)), jssm._causal_conv(x, w, b))
        return
    fn_t, fn_j = (tssm._conv_chunk, jssm._conv_chunk) if form == "chunk" else \
        (tssm._conv_step, jssm._conv_step)
    out, new_tail = fn_t(t(tail), t(x), t(w), t(b))
    jout, jtail = fn_j(jnp.asarray(tail), jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    close(out, jout)
    close(new_tail, jtail)


def test_conv_chunk_from_zeros_is_the_causal_conv():
    rng = np.random.default_rng(8)
    w, b = t(rng.standard_normal((4, 6))), t(rng.standard_normal(6))
    x = t(rng.standard_normal((B, 7, 6)))
    out, _ = tssm._conv_chunk(torch.zeros(B, 3, 6), x, w, b)
    assert torch.equal(out, tssm._causal_conv(x, w, b))


def test_softplus_is_jax_softplus_at_large_dt():
    """``torch.nn.functional.softplus`` returns x above its threshold (20);
    ``jax.nn.softplus`` is logaddexp(x, 0) everywhere.  The port's is the
    latter, to the last bit or two of the two libraries' log1p, across the
    threshold and far past it; in f32 both forms round to x above 20."""
    x = np.concatenate([np.linspace(-60, 120, 721), [19.99, 20.0, 20.01, 88.0, 1e4]]).astype(
        np.float32)
    got = tssm.softplus(t(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    above = x > 20
    np.testing.assert_array_equal(got[above], want[above])
    assert np.isfinite(got).all()


@functools.lru_cache(maxsize=None)
def mamba_case(quant):
    """One Mamba2 layer of the reduced mamba2 config in f32 (dt_bias large
    enough to reach softplus's upper range on some heads), the JAX and the
    port params, and a (B, 6, D) input."""
    jcfg = dataclasses.replace(jax_config("mamba2-780m"), dtype=jnp.float32, quant=quant)
    tcfg = dataclasses.replace(torch_config("mamba2-780m"), dtype=torch.float32, quant=quant)
    rng = np.random.default_rng(11)
    jp = numpy_params(jssm.mamba_defs(jcfg), rng)
    jp["dt_bias"] = jp["dt_bias"].at[0].set(25.0)  # softplus past torch's threshold
    jp["conv_x"] = jp["conv_x"] * 20  # a conv that counts next to the bias
    if quant:
        jp = {k: jax_quantize_weight(v, lead=0, n_contract=1) if k in ("wz", "wx", "wo") else v
              for k, v in jp.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.standard_normal((B, 6, jcfg.d_model)).astype(np.float32)
    s = jcfg.ssm
    c = s.d_inner(jcfg.d_model) + 2 * s.state_size
    conv = (rng.standard_normal((B, s.conv_width - 1, c)) * 0.5).astype(np.float32)
    state = (rng.standard_normal((B, s.num_heads(jcfg.d_model), s.head_dim, s.state_size))
             * 0.5).astype(np.float32)
    return jcfg, tcfg, jp, tp, x, conv, state


@pytest.mark.parametrize("quant", QUANTS)
def test_mamba_apply_and_prefill_match_jax(quant):
    jcfg, tcfg, jp, tp, x, _, _ = mamba_case(quant)
    with torch.inference_mode():
        tout = tssm.mamba_apply(tp, t(x), tcfg)
        tp_out, ttail, th = tssm.mamba_prefill_apply(tp, t(x), tcfg)
    agree(tout, jax.jit(jssm.mamba_apply, static_argnums=2)(jp, jnp.asarray(x), jcfg), quant)
    jout, jtail, jh = jax.jit(jssm.mamba_prefill_apply, static_argnums=2)(jp, jnp.asarray(x),
                                                                        jcfg)
    agree(tp_out, jout, quant)
    agree(ttail, jtail, quant)
    agree(th, jh, quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_mamba_chunk_and_decode_match_jax(quant):
    jcfg, tcfg, jp, tp, x, conv, state = mamba_case(quant)
    with torch.inference_mode():
        tc = tssm.mamba_chunk_apply(tp, t(x), t(conv), t(state), tcfg)
        td = tssm.mamba_decode_apply(tp, t(x[:, :1]), t(conv), t(state), tcfg)
    jc = jax.jit(jssm.mamba_chunk_apply, static_argnums=4)(
        jp, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(state), jcfg)
    jd = jax.jit(jssm.mamba_decode_apply, static_argnums=4)(
        jp, jnp.asarray(x[:, :1]), jnp.asarray(conv), jnp.asarray(state), jcfg)
    for got, want in zip((*tc, *td), (*jc, *jd)):
        agree(got, want, quant)


@pytest.mark.parametrize("quant", QUANTS)
def test_mamba_verify_commits_each_rows_own_snapshot(quant):
    """The verify window's outputs are JAX's, and committing accepted
    counts that differ by row (0, some, all: rows accept different counts in
    one tick) writes, in place, JAX's conv_all[:, a] and h_all[:, a] of that
    row.  An off-by-one in either would pass a test where every row
    accepts the same count."""
    jcfg, tcfg, jp, tp, x, conv, state = mamba_case(quant)
    jout, jconv_all, jh_all = jax.jit(jssm.mamba_verify_apply, static_argnums=4)(
        jp, jnp.asarray(x[:, :5]), jnp.asarray(conv), jnp.asarray(state), jcfg)
    with torch.inference_mode():
        tout, carry = tssm.mamba_verify_apply(tp, t(x[:, :5]), t(conv), t(state), tcfg)
        agree(tout, jout, quant)
        for acc in ([0, 4], [4, 2], [1, 0], [3, 3]):
            tconv, tstate = t(conv), t(state)
            tssm.mamba_verify_commit(carry, torch.tensor(acc), tconv, tstate, tcfg)
            for got, want in ((tconv, jconv_all), (tstate, jh_all)):
                agree(got, np.stack([np.asarray(want)[b, a] for b, a in enumerate(acc)]), quant)
    # the window's last snapshot is what chunked prefill of it carries on
    with torch.inference_mode():
        _, cconv, cstate = tssm.mamba_chunk_apply(tp, t(x[:, :5]), t(conv), t(state), tcfg)
        tconv, tstate = t(conv), t(state)
        tssm.mamba_verify_commit(carry, torch.tensor([4, 4]), tconv, tstate, tcfg)
    assert torch.equal(tconv, cconv)
    close(tstate, cstate.numpy())


def test_prefill_tail_is_left_padded_for_short_prompts():
    """A prompt shorter than W-1 = 3 tokens leaves a full-width conv tail,
    zeros on the left: the tail chunked prefill of the same prompt carries."""
    _, tcfg, _, tp, x, _, _ = mamba_case(None)
    c = tcfg.ssm.d_inner(tcfg.d_model) + 2 * tcfg.ssm.state_size
    for s in (1, 2, 3, 5):
        with torch.inference_mode():
            _, tail, h = tssm.mamba_prefill_apply(tp, t(x[:, :s]), tcfg)
            _, ctail, ch = tssm.mamba_chunk_apply(tp, t(x[:, :s]), torch.zeros(B, 3, c),
                                                  torch.zeros_like(h), tcfg)
        assert tail.shape == (B, 3, c)
        assert torch.equal(tail, ctail)
        assert not tail[:, :max(0, 3 - s)].any()
        close(h, ch.numpy())


def test_f32_leaves_of_a_bf16_layer_stay_f32():
    """A_log, dt_bias and D are f32 ParamDefs (as is the norm scale) in a
    bf16 model; wB/wC/wdt are bf16 and are not int8 projections."""
    from repro_torch.models.quant import QUANT_KEYS

    defs = tssm.mamba_defs(torch_config("mamba2-780m"))
    assert {k for k, d in defs.items() if k != "norm" and d.dtype == torch.float32} == \
        {"A_log", "dt_bias", "D"}
    assert {k for k in defs if k in QUANT_KEYS} == {"wz", "wx", "wo"}
