"""The ported slice as a whole: ``lstm_apply`` and ``lstm_stack_apply`` in
every mode, the paper-LSTM plan and the parameter hand-over, held against
the JAX package with the same weights (initialised in JAX, carried over as
numpy through ``params_from_numpy``) and the same numpy inputs.

f32 modes agree at 2e-5; ``impl="lut"`` follows the two-part rule of
``test_torch_lstm_kernels.py``; the int8 modes agree with their JAX
counterparts at 1e-4 and with the f32 path at 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lstm as jlstm
from repro.models.params import init_params as j_init_params
from repro_torch.core.fpga import LSTMWorkload, paper_workload
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.models import lstm as tlstm
from repro_torch.models import params as tparams

torch.set_num_threads(1)

SINGLE_MODES = [False, True, "pallas_step", "pallas_seq", "pallas_seq_q8"]
STACK_MODES = ["pallas_stack", "pallas_stack_q8", "pallas_seq", "pallas_seq_q8", "pallas_step",
               True]


def assert_parity(got, want, impl, tol, what=""):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if impl != "lut":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)
        return
    err = np.abs(got - want)
    assert err.max() <= 2e-2, (what, float(err.max()))
    assert (err > tol + tol * np.abs(want)).mean() <= 1e-3, what


def _params(d, hidden, layers=None):
    """JAX-initialised f32 weights and their carried-over twins."""
    defs = jlstm.lstm_defs(d, hidden) if layers is None else jlstm.lstm_stack_defs(d, hidden, layers)
    jp = jax.tree.map(lambda t: t.astype(jnp.float32), j_init_params(defs, jax.random.PRNGKey(0)))
    # a zero bias hides gate-order mistakes: give it values
    rng = np.random.default_rng(7)

    def with_bias(p):
        return {**p, "b": jnp.asarray((rng.standard_normal(p["b"].shape) * 0.1).astype(np.float32))}

    jp = with_bias(jp) if layers is None else [with_bias(p) for p in jp]
    tp = tparams.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _x(b, s, d):
    return np.random.default_rng(11).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("impl", ["exact", "pwl", "lut", "hard"])
@pytest.mark.parametrize("fused", SINGLE_MODES, ids=str)
def test_lstm_apply_matches_jax(fused, impl):
    jp, tp = _params(6, 20)
    x = _x(3, 11, 6)
    want = jlstm.lstm_apply(jp, jnp.asarray(x), impl=impl, fused=fused)
    got = tlstm.lstm_apply(tp, torch.from_numpy(x), impl=impl, fused=fused)
    assert_parity(got, want, impl, 1e-4 if fused == "pallas_seq_q8" else 2e-5, str(fused))


def test_lstm_apply_paths_agree():
    """All execution paths of the port compute the same function."""
    _, tp = _params(6, 20)
    x = torch.from_numpy(_x(3, 11, 6))
    want = tlstm.lstm_apply(tp, x, fused=True)
    for fused in (False, "pallas_step", "pallas_seq"):
        got = tlstm.lstm_apply(tp, x, fused=fused)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5,
                                   err_msg=str(fused))
    q8 = tlstm.lstm_apply(tp, x, fused="pallas_seq_q8")
    np.testing.assert_allclose(q8.numpy(), want.numpy(), atol=0.05)


@pytest.mark.parametrize("impl", ["exact", "lut"])
@pytest.mark.parametrize("fused", STACK_MODES, ids=str)
def test_lstm_stack_apply_matches_jax(fused, impl):
    jp, tp = _params(6, 20, layers=3)
    x = _x(5, 9, 6)
    want = jlstm.lstm_stack_apply(jp, jnp.asarray(x), impl=impl, fused=fused, block_b=2)
    got = tlstm.lstm_stack_apply(tp, torch.from_numpy(x), impl=impl, fused=fused, block_b=2)
    assert_parity(got, want, impl, 1e-4 if str(fused).endswith("q8") else 2e-5, str(fused))


def test_lstm_stack_apply_paths_agree():
    _, tp = _params(6, 20, layers=2)
    x = torch.from_numpy(_x(3, 9, 6))
    want = tlstm.lstm_stack_apply(tp, x, fused="pallas_seq")  # per-layer loop
    got = tlstm.lstm_stack_apply(tp, x, fused="pallas_stack")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    q8 = tlstm.lstm_stack_apply(tp, x, fused="pallas_stack_q8")
    np.testing.assert_allclose(q8.numpy(), want.numpy(), atol=0.05)
    _, one = _params(6, 20, layers=1)
    np.testing.assert_allclose(
        tlstm.lstm_stack_apply(one, x, fused="pallas_stack").numpy(),
        tlstm.lstm_apply(one[0], x, fused="pallas_seq").numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("apply,params", [("lstm_apply", None), ("lstm_stack_apply", 2)])
def test_unknown_fused_mode_raises(apply, params):
    jp, tp = _params(6, 20, layers=params)
    x = _x(2, 3, 6)
    with pytest.raises(ValueError, match="unknown"):
        getattr(tlstm, apply)(tp, torch.from_numpy(x), fused="not-a-mode")
    with pytest.raises(ValueError, match="unknown"):
        getattr(jlstm, apply)(jp, jnp.asarray(x), fused="not-a-mode")
    if apply == "lstm_apply":  # a stack mode is not a single-layer mode
        with pytest.raises(ValueError):
            tlstm.lstm_apply(tp, torch.from_numpy(x), fused="pallas_stack")


def test_mode_names_match_jax():
    assert tlstm.PALLAS_PATHS == jlstm.PALLAS_PATHS
    assert tlstm.STACK_FUSED_MODES == jlstm.STACK_FUSED_MODES


def test_lstm_cell_model_matches_jax():
    jp, tp = _params(6, 20)
    rng = np.random.default_rng(3)
    x, h, c = (rng.standard_normal(s).astype(np.float32) for s in ((4, 6), (4, 20), (4, 20)))
    for fused in (True, False):
        want = jlstm.lstm_cell(jp, *map(jnp.asarray, (x, h, c)), impl="pwl", fused=fused)
        got = tlstm.lstm_cell(tp, *map(torch.from_numpy, (x, h, c)), impl="pwl", fused=fused)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def test_ops_return_state():
    _, tp = _params(6, 20)
    x = torch.from_numpy(_x(3, 5, 6))
    hs, (hn, cn) = tops.lstm_seq(x, tp["w"], tp["u"], tp["b"], return_state=True)
    assert hs.shape == (3, 5, 20) and hn.shape == cn.shape == (3, 20)
    assert torch.equal(hs[:, -1], hn)
    y = tops.activation(x, fn="tanh", impl="hard")
    assert torch.equal(y, x.clamp(-1, 1))


# ---------------------------------------------------------------------------
# Launcher, workload, parameters
# ---------------------------------------------------------------------------
def test_plan_paper_lstm_runs_on_cpu(capsys):
    result = ttrain.plan_paper_lstm(batch=4, seq=6, device="cpu")
    out = capsys.readouterr().out
    assert "backend=cpu" in out and "max |Δ|" in out
    assert result["backend"] == "cpu" and result["max_abs_err"] < 1e-4
    assert "seq_us" not in result  # nothing is timed off the card
    # the paper's shape keeps its weights in one block; the plan says so
    assert result["path"] == "block" and result["resident"] and result["cluster"] == 1
    assert "path=block" in out and "cluster=1" in out and "resident=True" in out


def test_train_main_modes(capsys):
    assert ttrain.main(["--paper-lstm", "--batch", "2", "--seq", "3", "--device", "cpu"]) == 0
    capsys.readouterr()
    # --arch without --execute is the plan mode: five lines, no training
    assert ttrain.main(["--arch", "granite-3-8b"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 5
    with pytest.raises(SystemExit):
        ttrain.main([])
    capsys.readouterr()


def test_paper_workload_matches_jax():
    from repro.core.fpga import paper_workload as j_paper_workload

    lw, jw = paper_workload(), j_paper_workload()
    assert (lw.seq, lw.d_in, lw.hidden) == (jw.seq, jw.d_in, jw.hidden) == (28, 6, 20)
    assert lw.total_ops == jw.total_ops and lw.macs_per_step == jw.macs_per_step
    assert LSTMWorkload(seq=3).total_ops == type(jw)(seq=3).total_ops


def test_params_from_numpy_round_trip():
    jp, tp = _params(6, 20, layers=2)
    assert isinstance(tp, list) and set(tp[0]) == {"w", "u", "b"}
    for jl, tl in zip(jp, tp):
        for k in jl:
            assert tl[k].dtype == torch.float32 and tl[k].device.type == "cpu"
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    # copies: writing to the port's tensor leaves the source untouched
    src = {"w": np.ones((2, 3), np.float32)}
    out = tparams.params_from_numpy(src, device="cpu")
    out["w"].zero_()
    assert src["w"].sum() == 6
    ints = tparams.params_from_numpy({"q": np.arange(4, dtype=np.int8)}, device="cpu")
    assert ints["q"].dtype == torch.int8


def test_param_defs_and_init():
    from repro.models.params import count_params as j_count

    defs, jdefs = tlstm.lstm_stack_defs(6, 20, 3), jlstm.lstm_stack_defs(6, 20, 3)
    assert tparams.count_params(defs) == j_count(jdefs)
    assert [d["w"].shape for d in defs] == [d["w"].shape for d in jdefs]
    assert defs[0]["w"].dtype == torch.bfloat16 and defs[0]["b"].init == "zeros"
    a = tparams.init_params(defs, torch.Generator().manual_seed(5), device="cpu")
    b = tparams.init_params(defs, torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert float(a[0]["b"].abs().max()) == 0.0 and a[0]["w"].dtype == torch.bfloat16
    # fan-in scaling: std of (D, 4H) weights is about 1/sqrt(D)
    big = tparams.init_params(tlstm.lstm_defs(64, 64), torch.Generator().manual_seed(1), "cpu")
    assert abs(float(big["w"].float().std()) - 1 / 8) < 0.02
    st = tparams.stacked(4, tlstm.lstm_defs(6, 20))
    assert st["w"].shape == (4, 6, 80) and st["w"].logical[0] == "layers"
    with pytest.raises(ValueError):
        tparams.ParamDef((2, 3), ("a",))
    with pytest.raises(ValueError):
        tlstm.lstm_stack_defs(6, 20, 0)
