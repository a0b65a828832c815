"""The port's training loss (``models/model.py``: ``train_loss``,
``lm_loss``, ``_ce_block``, ``_remat``) against the JAX package's, on the
CPU, from the same numpy weights and batches (reduced configs in f32, B = 2,
S = 16): the loss and every gradient leaf of all ten archs.

Tolerances: the loss to 2e-5 relative; a gradient leaf to 1e-4 of its
largest magnitude.  A leaf whose exact gradient is 0 (an attention key
bias: softmax ignores a shift common to a query's scores) holds rounding
noise only, and is held to 1e-6 of the tree's largest gradient instead.

The ssm and hybrid families: the reference's SSD scan takes exp() of the
positive differences above the diagonal and masks them after, so its
backward multiplies 0 by inf and its gradients are NaN (pinned here); the
port masks the exp's argument too, its gradients are finite, equal to the
reference's on every finite entry and to the sequential recurrence
(``ssm.ssm_reference``) put in the chunked scan's place."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced_config as jax_config
from repro.models import model as jmodel
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.params import params_from_numpy, tree_flatten
from repro_torch.training.train_loop import _grads_of

from test_torch_moe import numpy_params

torch.set_num_threads(1)
B, S = 2, 16
LOSS_TOL, GRAD_TOL, ZERO_GRAD_TOL = 2e-5, 1e-4, 1e-6
DENSE_LIKE = ("granite-3-8b", "granite-34b", "starcoder2-15b", "qwen1.5-110b",
              "granite-moe-3b-a800m", "deepseek-v3-671b", "internvl2-76b", "whisper-tiny")
RECURRENT = ("mamba2-780m", "zamba2-7b")
# the reference's loss and gradients, jitted once per arch with the config static
jax_value_and_grad = jax.jit(jax.value_and_grad(jmodel.train_loss, has_aux=True),
                             static_argnums=2)


def configs(arch: str, **fields):
    return (dataclasses.replace(jax_config(arch), dtype=jnp.float32, **fields),
            dataclasses.replace(torch_config(arch), dtype=torch.float32, **fields))


def numpy_batch(cfg, rng) -> dict:
    """Tokens and labels (B, S); the vlm's patch rows with their labels
    masked, whisper's frames."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    rows = {"vision": cfg.frontend_seq, "audio": cfg.encoder_seq}.get(cfg.frontend)
    if rows is not None:
        batch["frontend_embeds"] = (0.02 * rng.standard_normal((B, rows, cfg.d_model))
                                    ).astype(np.float32)
    if cfg.frontend == "vision":
        batch["labels"][:, :cfg.frontend_seq] = -1
    return batch


@functools.lru_cache(maxsize=None)
def case(arch: str):
    """(numpy params, numpy batch, the reference's loss, metrics and
    gradient leaves in tree order) at seed 0."""
    jcfg, _ = configs(arch)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, numpy_params(jmodel.param_defs(jcfg), rng))
    batch = numpy_batch(jcfg, rng)
    (loss, metrics), grads = jax_value_and_grad(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    return (params, batch, float(loss), {k: float(v) for k, v in metrics.items()},
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def port_grads(arch: str, **fields):
    params, batch, *_ = case(arch)
    _, tcfg = configs(arch, **fields)
    loss, metrics, grads = _grads_of(params_from_numpy(params, "cpu"),
                                     {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        [g.numpy() for g in tree_flatten(grads)]


def grads_close(got: list, want: list, finite_only: bool = False):
    """Each leaf within GRAD_TOL of its largest |g| (ZERO_GRAD_TOL of the
    tree's for a leaf that is rounding noise); with ``finite_only`` the
    entries where ``want`` is NaN are skipped."""
    assert len(got) == len(want)
    top = max(float(np.nanmax(np.abs(w))) for w in want if np.isfinite(w).any())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        keep = np.isfinite(w) if finite_only else np.ones(w.shape, bool)
        if not keep.any():
            continue
        scale = float(np.abs(w[keep]).max())
        err = float(np.abs(g[keep] - w[keep]).max())
        assert err <= max(GRAD_TOL * scale, ZERO_GRAD_TOL * top), (err, scale, top)


def loss_close(got: float, want: float):
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


@pytest.mark.parametrize("arch", DENSE_LIKE)
def test_loss_and_gradients_match_jax(arch):
    """dense, moe (granite-moe and deepseek with MLA and the MTP head), vlm
    and audio: the loss, its parts and every gradient leaf."""
    _, _, jloss, jmetrics, jgrads = case(arch)
    loss, metrics, grads = port_grads(arch)
    loss_close(loss, jloss)
    assert metrics.keys() == jmetrics.keys()
    for k in metrics:
        assert abs(metrics[k] - jmetrics[k]) <= LOSS_TOL * max(abs(jmetrics[k]), 1e-3), k
    grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", RECURRENT)
def test_reference_ssd_gradients_are_nan(arch):
    """The reference's behaviour, pinned: its loss is finite, its gradients
    NaN at many entries (``jnp.where(tri, jnp.exp(diff), 0.0)``)."""
    _, _, jloss, _, jgrads = case(arch)
    assert np.isfinite(jloss)
    assert sum(int(np.isnan(g).sum()) for g in jgrads) > 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_ssm_gradients_are_finite_and_the_references_where_it_is_finite(arch):
    _, _, jloss, _, jgrads = case(arch)
    loss, _, grads = port_grads(arch)
    loss_close(loss, jloss)
    assert all(np.isfinite(g).all() for g in grads)
    grads_close(grads, jgrads, finite_only=True)


@pytest.mark.parametrize("arch", RECURRENT)
def test_ssm_gradients_match_the_sequential_recurrence(arch, monkeypatch):
    """The chunked scan's gradients equal those of the per-step recurrence
    (``ssm_reference``, which has no masked exp) put in its place."""
    loss, _, grads = port_grads(arch)
    monkeypatch.setattr(tssm, "ssd_chunked", lambda x, dt, a, bm, cm, chunk, h0=None:
                        tssm.ssm_reference(x, dt, a, bm, cm, h0))
    want_loss, _, want = port_grads(arch)
    loss_close(loss, want_loss)
    grads_close(grads, want)


def test_masked_exp_keeps_the_forward_bits_and_a_finite_gradient():
    """``_segments`` gives exactly the values of a ``where`` after the exp
    and a finite gradient where that one's is NaN."""
    cum = torch.cumsum(-torch.rand(2, 3, 8, 4, generator=torch.Generator().manual_seed(0)) * 30,
                       dim=2).requires_grad_()
    n = cum.shape[-2]
    diff = cum[..., :, None, :] - cum[..., None, :, :]
    tri = torch.tril(torch.ones((n, n), dtype=torch.bool))[..., None]
    old = torch.where(tri, torch.exp(diff), torch.zeros(()))
    new = tssm._segments(cum)
    assert torch.equal(old, new)
    (g_old,) = torch.autograd.grad(old.sum(), cum)
    (g_new,) = torch.autograd.grad(new.sum(), cum)
    assert torch.isnan(g_old).any() and torch.isfinite(g_new).all()


@pytest.mark.parametrize("arch", ["granite-3-8b", "zamba2-7b", "deepseek-v3-671b"])
def test_remat_modes_give_the_same_gradients(arch):
    """"none", "full" and "dots" rematerialise differently, never change a
    gradient (zamba2: its shared block too; deepseek: both stacks)."""
    base = port_grads(arch, remat="none")
    for mode in ("full", "dots"):
        loss, _, grads = port_grads(arch, remat=mode)
        assert loss == base[0]
        for g, w in zip(grads, base[2]):
            np.testing.assert_array_equal(g, w)


class CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
        return func(*args, **(kwargs or {}))


def backward_products(arch: str, remat: str) -> int:
    """Matrix products the backward of ``train_loss`` runs: the gradients'
    own, plus those it recomputes."""
    params, batch, *_ = case(arch)
    _, tcfg = configs(arch, remat=remat)
    leaves = tree_flatten(tp := params_from_numpy(params, "cpu"))
    for p in leaves:
        p.requires_grad_()
    loss, _ = tmodel.train_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    with CountProducts() as mode:
        torch.autograd.grad(loss, leaves)
    return mode.count


def test_remat_recomputes_what_its_policy_does_not_save():
    """"dots" recomputes only the batched products (attention's), "full"
    every product of a layer, "none" nothing."""
    none, dots, full = (backward_products("granite-3-8b", m) for m in ("none", "dots", "full"))
    assert none < dots < full, (none, dots, full)


def test_remat_is_off_without_autograd():
    _, tcfg = configs("granite-3-8b")
    f = lambda p, x: (x, x)  # noqa: E731
    with torch.no_grad():
        assert tmodel._remat(f, tcfg) is f
    assert tmodel._remat(f, dataclasses.replace(tcfg, remat="none")) is f
    assert tmodel._remat(f, tcfg) is not f


def test_sequence_chunked_ce_matches_the_references():
    """``logits_chunk`` = 4 over S = 16: the reference's chunked loss and
    gradients."""
    params, batch, *_ = case("granite-3-8b")
    jcfg, _ = configs("granite-3-8b", logits_chunk=4)
    (jloss, _), jgrads = jax_value_and_grad(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, _, grads = port_grads("granite-3-8b", logits_chunk=4)
    loss_close(loss, float(jloss))
    grads_close(grads, [np.asarray(g) for g in jax.tree.leaves(jgrads)])


def test_chunked_attention_gradients_match_jax():
    """``attn_chunk`` = 4 under S = 16 > 2 x 4: both packages take the
    online-softmax attention (``attention_chunked``, the path of a long
    training sequence), loss and gradients."""
    params, batch, *_ = case("granite-3-8b")
    jcfg, _ = configs("granite-3-8b", attn_chunk=4)
    (jloss, _), jgrads = jax_value_and_grad(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, _, grads = port_grads("granite-3-8b", attn_chunk=4)
    loss_close(loss, float(jloss))
    grads_close(grads, [np.asarray(g) for g in jax.tree.leaves(jgrads)])


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b"])
def test_sequence_chunked_ce_equals_the_whole_vocab_ce(arch):
    """The chunked loss (deepseek: its MTP loss too, over S - 1 = 15
    positions, which 4 does not divide: whole-vocab there) and gradients
    equal the whole-vocab ones."""
    loss, _, grads = port_grads(arch, logits_chunk=4)
    whole_loss, _, whole = port_grads(arch)
    loss_close(loss, whole_loss)
    grads_close(grads, whole)


def test_vocab_padding_and_masked_labels():
    """Padded vocab columns take no probability; labels < 0 count nothing:
    the loss equals a float64 cross-entropy over the real vocab and the
    unmasked positions."""
    _, tcfg = configs("granite-3-8b")  # vocab 512 = padded_vocab: pad it
    tcfg = dataclasses.replace(tcfg, vocab_size=500)
    rng = np.random.default_rng(3)
    emb = {"tokens": torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32)),
           "unembed": torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))}
    hidden = torch.from_numpy(rng.standard_normal((B, S, 64)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 500, (B, S)))
    labels[0, :5] = -1
    got = float(tmodel.lm_loss({"embed": emb}, hidden, labels, tcfg))
    logits = (hidden.double() @ emb["unembed"].double())[..., :500]
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels.clamp_min(0)[..., None])[
        ..., 0]
    keep = labels >= 0
    assert abs(got - float(nll[keep].mean())) <= 1e-5 * abs(got)
