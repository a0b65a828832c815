"""Cross-framework parity of the activation variants: the same numpy inputs
through the JAX package and through the PyTorch port (on the CPU, where the
port's kernel wrapper takes its plain version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.activations import _sigmoid_table as j_kernel_table
from repro.kernels.activations import activation as j_activation
from repro.models import activations as jact
from repro_torch.kernels import ref as tref
from repro_torch.kernels.activations import activation as t_activation
from repro_torch.kernels.activations import activation_plain
from repro_torch.models import activations as tact

torch.set_num_threads(1)

FNS = ["sigmoid", "tanh", "silu", "gelu"]
IMPLS = ["exact", "pwl", "lut", "hard"]
SHAPES = [
    ((64, 128), "float32"),
    ((3, 33, 130), "float32"),   # ragged rows: the reference pads, the port does not
    ((128, 256), "bfloat16"),
]


def _inputs(shape, dtype):
    x = (np.random.default_rng(0).standard_normal(shape) * 4.0).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_activation_kernel_matches_jax_kernel(fn, impl, shape, dtype):
    """Port's kernel wrapper vs the Pallas kernel in interpret mode."""
    xj, xt = _inputs(shape, dtype)
    want = j_activation(xj, fn=fn, impl=impl, block_rows=32, interpret=True)
    got = t_activation(xt, fn=fn, impl=impl)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_activation_semantics_match_jax(fn, impl, shape, dtype):
    """``models.activations`` (through ``ref.activation_ref``) on both sides."""
    xj, xt = _inputs(shape, dtype)
    want = jref.activation_ref(xj, fn=fn, impl=impl)
    got = tref.activation_ref(xt, fn=fn, impl=impl)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("impl", IMPLS)
def test_activation_plain_matches_semantics(fn, impl):
    """The kernel's arithmetic (tanh as 2σ(2x) − 1) against the semantics
    (``torch.tanh``) inside the port, as ``test_kernels.py`` holds the Pallas
    kernel against its oracle."""
    _, xt = _inputs((3, 33, 130), "float32")
    got = activation_plain(xt, fn=fn, impl=impl)
    want = tref.activation_ref(xt, fn=fn, impl=impl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_sigmoid_table_matches_jax():
    table = tact._sigmoid_table().numpy()
    assert table.shape == (tact.LUT_SIZE,) and table.dtype == np.float32
    np.testing.assert_allclose(table, np.asarray(jact._sigmoid_table()), atol=1e-7, rtol=0)
    np.testing.assert_allclose(table, np.asarray(j_kernel_table()), atol=1e-7, rtol=0)


def test_constants_match_jax():
    assert tact.LUT_SIZE == jact.LUT_SIZE and tact.LUT_RANGE == jact.LUT_RANGE
    assert tact.VARIANT_COST == jact.VARIANT_COST
    assert tact.VARIANT_ERROR == jact.VARIANT_ERROR


@pytest.mark.parametrize("impl", ["pwl", "lut", "hard"])
def test_activation_variant_error_bounds(impl):
    """Measured max |variant − exact| stays within the documented bounds."""
    x = torch.linspace(-8.0, 8.0, 4001)
    err = float((tact.get_sigmoid(impl)(x) - torch.sigmoid(x)).abs().max())
    assert err <= tact.VARIANT_ERROR[impl] * 1.05, (impl, err)


def test_lut_index_rounds_half_to_even():
    """Inputs that land exactly between two table entries pick the even one,
    as ``jnp.round`` does in the reference."""
    idx = np.arange(0, 255, dtype=np.float64) + 0.5
    x = (idx * 8.0 / 255.0).astype(np.float32)
    got = tact.sigmoid_lut(torch.from_numpy(x)).numpy()
    want = np.asarray(jact.sigmoid_lut(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ["silu", "gelu", "relu"])
def test_get_activation_families(family):
    _, xt = _inputs((16, 32), "float32")
    xj = jnp.asarray(xt.numpy())
    got = tact.get_activation(family, "pwl")(xt).numpy()
    want = np.asarray(jact.get_activation(family, "pwl")(xj))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError):
        tact.get_activation("swish")


def test_activation_rejects_unknown_names():
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        t_activation(x, fn="softmax")
    with pytest.raises(ValueError):
        t_activation(x, impl="cubic")
