"""The port's MoE module and K5's batch axis against the JAX package, on the
CPU at the reduced configs: the router (padding experts masked, the
lower-index rule on ties), the dense path, the shared expert, the aux loss,
``moe_apply``, the per-device dispatch/combine pieces of the a2a path
(capacity drops included), the batched ``int8_matmul`` bit for bit against
``jax.vmap`` of the reference and against one 2-D call per product, and the
batched ``qeinsum`` against the reference's (which maps over the label).

f32 outputs agree to 1e-5 of their largest magnitude; ids, positions and
every int8 product bit for bit.  With int8 weights the MoE output is held to
the int8 rule of ``test_torch_chunked_prefill`` (max 0.1, mean 0.02 of the
largest magnitude): an f32 last-bit difference in the router or in the
first product can move an activation across an edge of its row
quantization."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models import quant as jquant
from repro.models.params import ParamDef as JaxParamDef
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.kernels import runtime
from repro_torch.kernels.int8_matmul import _x_shared, int8_matmul, int8_matmul_plain, plan
from repro_torch.models import moe as tmoe
from repro_torch.models import quant as tquant
from repro_torch.models.params import params_from_numpy

from test_torch_chunked_prefill import close_q8

torch.set_num_threads(1)
TOL = 1e-5
# the reference's MoE functions under jax.jit, the config static (one compile
# a shape, where op by op compiles every operation)
moe_dense = jax.jit(jmoe._moe_dense, static_argnums=2)
moe_apply = jax.jit(jmoe.moe_apply, static_argnums=2)
shared_ffn = jax.jit(jmoe._shared_ffn, static_argnums=2)
GRANITE_MOE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v3-671b"


def configs(arch: str, **moe_fields):
    """The reduced config of both packages in f32; ``moe_fields`` replace
    fields of its MoEConfig (e.g. padding experts)."""
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               moe=dataclasses.replace(jcfg.moe, **moe_fields))
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32,
                               moe=dataclasses.replace(tcfg.moe, **moe_fields))
    return jcfg, tcfg


def numpy_params(defs, rng):
    """f32 weights for a JAX ParamDef tree, drawn with numpy by the
    reference's rules (std 1/sqrt(fan-in), 0.02 normal, ones); leaves that
    start at zero get small random values so that they count.  jax.random
    would compile its sampler once per leaf shape, which was most of this
    file's time."""
    def draw(d):
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        if d.init == "scalar_log":  # Mamba's A_log, log of [1, 16)
            return np.log1p(15.0 * rng.random(d.shape)).astype(np.float32)
        x = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "zeros":
            return x * 0.1
        if d.init in ("normal", "embed"):
            return x * d.scale * (0.02 if d.init == "normal" else 1.0)
        fan_in = d.shape[-2] if len(d.shape) >= 3 else d.shape[0]
        return x * d.scale / np.sqrt(max(fan_in, 1))

    return jax.tree.map(lambda d: jnp.asarray(draw(d)), defs,
                        is_leaf=lambda d: isinstance(d, JaxParamDef))


def jax_quantize_weight(w, *, lead: int, n_contract: int) -> jquant.QuantTensor:
    """``repro.models.quant._quantize_weight`` computed in numpy: the same
    f32 division, half-to-even rounding and clip, so the same bits
    (``test_numpy_quantizer_is_the_reference_bit_for_bit``).  JAX runs the
    reference op by op and compiles each op once per weight shape, which was
    most of the JAX time of the int8 tests."""
    w = np.asarray(w, np.float32)
    k = math.prod(w.shape[lead:lead + n_contract])
    n_dims = w.shape[lead + n_contract:]
    w2 = w.reshape(*w.shape[:lead], k, math.prod(n_dims) if n_dims else 1)
    scale = np.maximum(np.abs(w2).max(axis=-2), np.float32(1e-8)) / np.float32(127.0)
    q = np.clip(np.round(w2 / scale[..., None, :]), -127, 127).astype(np.int8)
    return jquant.QuantTensor(q=jnp.asarray(q.reshape(w.shape)),
                              scale=jnp.asarray(scale.reshape(*w.shape[:lead], *n_dims)))


def moe_params(jcfg, seed: int = 0, quant: bool = False):
    """One MoE layer's f32 weights for JAX, quantized there when ``quant``,
    and the same carried into the port."""
    jp = numpy_params(jmoe.moe_defs(jcfg), np.random.default_rng(seed))
    if quant:  # experts (E, d, f) have one lead axis, the shared expert none
        qw = lambda w: jax_quantize_weight(w, lead=w.ndim - 2, n_contract=1)  # noqa: E731
        jp = {k: v if k == "router" else
              {kk: qw(vv) for kk, vv in v.items()} if isinstance(v, dict) else qw(v)
              for k, v in jp.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def tokens(seed: int, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("shape,lead,n_contract", [
    ((40, 24), 0, 1), ((3, 40, 24), 1, 1), ((2, 3, 40, 24), 2, 1), ((4, 8, 40), 0, 2),
    ((2, 4, 8, 40), 1, 2), ((40, 4, 6), 0, 1)])
def test_numpy_quantizer_is_the_reference_bit_for_bit(shape, lead, n_contract):
    """The tests' numpy quantizer against the reference's, over every
    layout ``quantize_params`` hands it (lead axes of layers and experts,
    one or two contraction axes, several output axes), with an all-zero
    column (the 1e-8 floor of the scale) and values on rounding ties."""
    rng = np.random.default_rng(len(shape) * 10 + lead + n_contract)
    w = rng.standard_normal(shape).astype(np.float32)
    k = math.prod(shape[lead:lead + n_contract])
    cols = w.reshape(*shape[:lead], k, -1)  # a view: the columns the quantizer scales
    cols[..., 0] = 0.0
    # column 1: amax 127, so its scale is 1.0 and every other weight an exact tie
    cols[..., 1] = rng.integers(-127, 127, cols[..., 1].shape) + np.float32(0.5)
    cols[..., 0, 1] = 127.0
    want = jquant._quantize_weight(jnp.asarray(w), lead=lead, n_contract=n_contract)
    got = jax_quantize_weight(w, lead=lead, n_contract=n_contract)
    for a, b in ((got.q, want.q), (got.scale, want.scale)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("padded", [0, 12])
def test_router_weights_ids_and_padding_mask_match_jax(padded):
    """granite-moe-reduced with 8 experts, alone and padded to 12: the 4
    padding experts never win and get probability 0."""
    jcfg, tcfg = configs(GRANITE_MOE, padded_experts=padded)
    jp, tp = moe_params(jcfg, seed=1)
    x = tokens(2, (20, jcfg.d_model))
    jw, jids, jprobs = jmoe._router(jp, jnp.asarray(x), jcfg)
    tw, tids, tprobs = tmoe._router(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tw, jw)
    close(tprobs, jprobs)
    assert tprobs.shape[-1] == (padded or 8)
    if padded:
        assert int(tids.max()) < 8 and not tprobs[:, 8:].any()


def test_router_takes_the_lower_index_on_ties_as_jax():
    """A router whose columns repeat gives equal probabilities: top-k keeps
    the lower expert index first, as ``jax.lax.top_k`` does."""
    jcfg, tcfg = configs(GRANITE_MOE, top_k=3)
    jp, tp = moe_params(jcfg, seed=3)
    router = np.asarray(jp["router"]).copy()
    router[:, 4:] = router[:, :4]  # experts e and e + 4 always tie
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = tokens(4, (16, jcfg.d_model))
    _, jids, _ = jmoe._router(jp, jnp.asarray(x), jcfg)
    tw, tids, _ = tmoe._router(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    # the two tied copies of the winner come first, the lower index first
    assert (tids[:, 1] == tids[:, 0] + 4).all()
    torch.testing.assert_close(tw.sum(-1), torch.ones(16))


# ---------------------------------------------------------------------------
# dense path, shared expert, aux loss, moe_apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [GRANITE_MOE, DEEPSEEK])
def test_moe_apply_dense_shared_and_aux_match_jax_in_f32(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = moe_params(jcfg, seed=5)
    x = tokens(6, (2, 5, jcfg.d_model))
    jy, jaux = moe_dense(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe._moe_dense(tp, torch.from_numpy(x), tcfg)
    close(ty, jy)
    close(taux, jaux)
    _, jids, jprobs = jmoe._router(jp, jnp.asarray(x.reshape(10, -1)), jcfg)
    close(tmoe._aux_loss(torch.from_numpy(np.array(jprobs)),
                         torch.from_numpy(np.array(jids)).long(), tcfg),
          jmoe._aux_loss(jprobs, jids, jcfg))
    jy, jaux = moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    close(ty, jy)
    close(taux, jaux)
    if jcfg.moe.num_shared:
        close(tmoe._shared_ffn(tp["shared"], torch.from_numpy(x), tcfg),
              shared_ffn(jp["shared"], jnp.asarray(x), jcfg))


@pytest.mark.parametrize("arch", [GRANITE_MOE, DEEPSEEK])
def test_moe_apply_with_int8_weights_matches_jax(arch):
    jcfg, tcfg = configs(arch, padded_experts=12)
    jp, tp = moe_params(jcfg, seed=7, quant=True)
    assert isinstance(tp["wg"], tquant.QuantTensor)
    x = tokens(8, (2, 6, jcfg.d_model))
    jy, jaux = moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    close_q8(ty, jy)
    close(taux, jaux)


def test_moe_apply_refuses_a_mesh():
    """``moe_apply`` takes no mesh argument: it reads the active mesh, as
    the reference does, and under a mesh of one rank takes the dense path
    (the sharded paths: ``tests/test_torch_distributed.py``)."""
    from repro_torch.sharding.rules import MeshShape, activate_mesh

    _, tcfg = configs(GRANITE_MOE)
    _, tp = moe_params(configs(GRANITE_MOE)[0])
    x = torch.from_numpy(tokens(3, (1, 2, tcfg.d_model)))
    with pytest.raises(TypeError):
        tmoe.moe_apply(tp, x, tcfg, mesh=object())
    want = tmoe.moe_apply(tp, x, tcfg)
    with activate_mesh(MeshShape({"data": 1, "model": 1})):
        got = tmoe.moe_apply(tp, x, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# dispatch / combine: exact ids and positions, capacity drops
# ---------------------------------------------------------------------------
def test_positions_in_expert_match_jax():
    ids = np.random.default_rng(9).integers(0, 6, 40).astype(np.int32)
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(ids), 6))
    got = tmoe._positions_in_expert(torch.from_numpy(ids).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity", [2, 3, 12])
def test_dispatch_and_combine_match_jax_with_and_without_drops(capacity):
    """12 tokens, top-2 of 8 experts: a capacity of 2 or 3 drops
    assignments (switch-transformer semantics), 12 keeps them all."""
    jcfg, tcfg = configs(GRANITE_MOE)
    jp, tp = moe_params(jcfg, seed=10)
    xt = tokens(11, (12, jcfg.d_model))
    jbuf, jroute, (jprobs, jids) = jmoe._dispatch_local(jp, jnp.asarray(xt), jcfg, capacity)
    tbuf, troute, (tprobs, tids) = tmoe._dispatch_local(tp, torch.from_numpy(xt), tcfg, capacity)
    for got, want in zip(troute[1:], jroute[1:]):  # ids, positions, token indices
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    close(troute[0], jroute[0])
    dropped = int((troute[2] >= capacity).sum())
    assert (dropped > 0) == (capacity < 12)
    # an expert "output": the buffer scaled per expert
    scale = np.arange(1, 9, dtype=np.float32)[:, None, None]
    jy = jmoe._combine_local(jbuf * scale, jroute, 12, jcfg.d_model, jnp.float32)
    ty = tmoe._combine_local(tbuf * torch.from_numpy(scale), troute, 12, tcfg.d_model,
                             torch.float32)
    close(ty, jy)


# ---------------------------------------------------------------------------
# K5 over a batch axis, and the batched qeinsum
# ---------------------------------------------------------------------------
def _batched_operands(seed: int, e: int, m: int, k: int, n: int, shared_x: bool):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1 if shared_x else e, m, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    xq, sx = jax.vmap(jref.quantize_rowwise)(jnp.asarray(x))
    wq, sw = jax.vmap(jref.quantize_colwise)(jnp.asarray(w))
    if shared_x:
        xq, sx = (jnp.broadcast_to(a, (e, *a.shape[1:])) for a in (xq, sx))
    return [np.array(a) for a in (xq, wq, sx, sw)]


@pytest.mark.parametrize("e,m,k,n,shared_x", [
    (3, 5, 37, 19, False), (4, 1, 64, 96, False), (6, 17, 130, 33, True),
    (48, 4, 96, 32, True), (2, 33, 200, 129, False)])
def test_batched_int8_matmul_is_bit_identical_to_jax_vmap_and_to_2d_calls(e, m, k, n, shared_x):
    xq, wq, sx, sw = _batched_operands(e * m + n, e, m, k, n, shared_x)
    want = np.asarray(jax.vmap(jref.int8_matmul_ref)(*map(jnp.asarray, (xq, wq, sx, sw))))
    t = [torch.from_numpy(a) for a in (xq, wq, sx, sw)]
    if shared_x:  # one product's x, expanded over the batch (stride 0)
        t[0], t[2] = t[0][:1].expand(e, m, k), t[2][:1].expand(e, m, 1)
        assert t[0].stride(0) == 0
    runtime.reset_launch_counts()
    got = int8_matmul(*t)
    assert runtime.launch_counts() == {}  # CPU tensors: the plain version
    assert tuple(got.shape) == (e, m, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    for i in range(e):
        one = int8_matmul(t[0][i].contiguous(), t[1][i], t[2][i].contiguous(), t[3][i])
        np.testing.assert_array_equal(one.numpy().view(np.uint32), want[i].view(np.uint32))


def test_plain_version_slices_a_large_batch_with_the_same_bits(monkeypatch):
    from repro_torch.kernels import int8_matmul as k5

    xq, wq, sx, sw = (torch.from_numpy(a) for a in _batched_operands(12, 5, 3, 64, 40, False))
    whole = int8_matmul_plain(xq, wq, sx, sw)
    monkeypatch.setattr(k5, "PLAIN_BYTES", 2 * 8 * 64 * 40)  # two products a slice
    assert torch.equal(int8_matmul_plain(xq, wq, sx, sw), whole)


def test_batched_wrapper_refuses_what_the_kernel_does_not_take():
    xq, wq, sx, sw = (torch.from_numpy(a) for a in _batched_operands(13, 3, 4, 32, 8, False))
    with pytest.raises(ValueError, match="2-D, or both 3-D"):
        int8_matmul(xq, wq[0], sx, sw[0])
    with pytest.raises(ValueError, match="inconsistent"):
        int8_matmul(xq, wq[:2], sx, sw[:2])
    with pytest.raises(ValueError, match="inconsistent"):
        int8_matmul(xq, wq, sx[:, :, 0], sw)


def test_x_shared_by_the_batch_or_stacked_never_mixed():
    """The kernel takes one flag for x and its scales: both shared by every
    product (batch stride 0), or both stacked.  A mix is refused before any
    launch (the check the card's wrapper makes)."""
    xq, _, sx, _ = (torch.from_numpy(a) for a in _batched_operands(14, 3, 4, 32, 8, False))
    shared_x, shared_s = xq[:1].expand(3, 4, 32), sx[:1].expand(3, 4, 1)
    assert _x_shared(xq, sx) == 0 and _x_shared(shared_x, shared_s) == 1
    assert _x_shared(xq[:1], sx[:1]) == 0  # one product: nothing to share
    for x, s, bad in ((shared_x, sx, "x_scale"), (xq, shared_s, "x_scale"),
                      (xq[:, :, :16], sx, "x_q")):
        with pytest.raises(ValueError, match=f"both shared.*{bad}"):
            _x_shared(x, s)


@pytest.mark.parametrize("e,m,k,n", [(48, 4, 1536, 512), (48, 4, 512, 1536),
                                     (48, 256, 1536, 512), (256, 4, 7168, 2048),
                                     (256, 4, 2048, 7168)])
def test_plan_sees_the_batch(e, m, k, n):
    """The expert shapes of granite-moe and deepseek-v3: the grid's z (batch
    x chunks of K) fits the kernel, the chunks cover K, and a batch never
    splits K more than one product of the shape does (the batch already
    fills the card)."""
    p = plan(m, k, n, batch=e)
    one = plan(m, k, n)
    assert e * p.split_k <= 65535
    assert (p.split_k - 1) * p.k_chunk < k <= p.split_k * p.k_chunk
    assert p.split_k <= one.split_k
    assert p.blocks(m, n, e) == e * p.blocks(m, n)


@pytest.mark.parametrize("spec,shared", [("ecd,edf->ecf", False), ("ecd,edf->ecf", True),
                                         ("ecf,efd->ecd", False)])
def test_batched_qeinsum_is_one_product_and_matches_jax(spec, shared, monkeypatch):
    """The expert einsums: one row quantization and ONE int8_matmul over the
    expert axis (an x expanded over the experts is quantized once), the
    bits of the reference's vmapped qeinsum."""
    e, c, d, f = 5, 6, 16, 24
    rng = np.random.default_rng(len(spec) + shared)
    k_in, n_out = (d, f) if spec.startswith("ecd") else (f, d)
    x = rng.standard_normal((1 if shared else e, c, k_in)).astype(np.float32)
    w = rng.standard_normal((e, k_in, n_out)).astype(np.float32)
    jq = jquant._quantize_weight(jnp.asarray(w), lead=1, n_contract=1)
    tq = tquant.quantize_weight(torch.from_numpy(w), lead=1, n_contract=1)
    jx = jnp.broadcast_to(jnp.asarray(x), (e, *x.shape[1:]))
    tx = torch.from_numpy(x).expand(e, *x.shape[1:])
    want = np.asarray(jquant.qeinsum(spec, jx, jq))
    calls, quantized = [], []
    real_mm, real_q = tquant.int8_matmul, tquant.quantize_rowwise
    monkeypatch.setattr(tquant, "int8_matmul", lambda *a: calls.append(a[0].shape) or real_mm(*a))
    monkeypatch.setattr(tquant, "quantize_rowwise",
                        lambda t: quantized.append(t.shape) or real_q(t))
    got = tquant.qeinsum(spec, tx, tq)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert calls == [torch.Size((e, c, x.shape[-1]))]
    assert quantized == [torch.Size(((1 if shared else e) * c, x.shape[-1]))]


def test_batched_qeinsum_is_one_launch_on_the_card():
    """On a CUDA tensor the expert einsum is ONE K5 launch over the expert
    axis, bit-identical to E two-dimensional launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    e, c, d, f = 48, 4, 1536, 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((c, d), generator=gen, device="cuda")[None].expand(e, c, d)
    w = tquant.quantize_weight(torch.randn((e, d, f), generator=gen, device="cuda"), lead=1,
                               n_contract=1)
    runtime.reset_launch_counts()
    got = tquant.qeinsum("ecd,edf->ecf", x, w)
    assert runtime.launch_counts() == {"int8_matmul": 1}
    want = torch.stack([tquant.qeinsum("cd,df->cf", x[i], tquant.QuantTensor(w.q[i], w.scale[i]))
                        for i in range(e)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
