"""The dry run's traced half (``repro_torch.launch.dryrun.lower_cell``,
``depth_fit_analysis``; ``repro_torch.launch.trace``): a rank's real step
run on fake tensors over a fake world.

  * On a fake 2 x 4 world, for each family's reduced config, train,
    prefill and decode (``long_500k`` too for the recurrent families, its
    one row whole on every rank): the collectives the step sent equal the
    analytic count (``step_collectives``, ``forward_collectives``) op by
    op.
  * The depth fit's extrapolation equals the full-depth trace (1e-9
    relative), FLOPs and each collective kind, for a train step and for a
    decode step.
  * Under ``remat="full"`` the peak live bytes grow with depth by the layer
    input's bytes, the layer's state shards and its compute-layout copies
    (5%): a dense stack (granite-3-8b) and a MoE stack (deepseek-v3-671b,
    whose expert leaves Adafactor once gathered whole: 45 GB a MoE layer on
    16 x 16), both at full width on 16 x 16.
  * The port's traced matmul FLOPs against the reference's compiled
    ``cost_analysis()`` FLOPs (elementwise work included) at each reduced
    config on one device: within ``FLOP_BAND`` for a train step,
    ``DECODE_FLOP_BAND`` for a decode step.
  * Nothing falls back: a step that fails under fake tensors (a train
    step, a decode step's attention) raises, and the fake world is gone
    afterwards.
  * On a (2, 2) gloo world: ``relayout``'s moves against the whole tensor's
    blocks, and the mesh Trainer under fsdp (expert leaves moved by
    all-to-all, Adafactor on the rank's experts) against the mesh Trainer
    without."""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.trace import fake_world, trace
from repro_torch.launch.world import run_world
from repro_torch.sharding import layout
from repro_torch.sharding.rules import MeshShape, make_rules, shard_shape
from repro_torch.training import train_loop as TL

import torch_dist_workers as W
from test_torch_sharding_rules import reference_run

MESH24 = MeshShape({"data": 2, "model": 4})
SINGLE = MeshShape({"data": 16, "model": 16})
BATCH, SEQ = 16, 256  # 8 rows a rank: the MoE layers' a2a path, the tokens split over "model"
FAMILY_ARCHS = ("granite-3-8b", "internvl2-76b", "granite-moe-3b-a800m", "deepseek-v3-671b",
                "mamba2-780m", "zamba2-7b", "whisper-tiny")
FLOP_BATCH, FLOP_SEQ = 2, 256
# the port's matmul FLOPs over XLA's count (elementwise FLOPs included), naive attention, no
# remat: 0.796 (mamba2-780m) to 0.914 (granite-moe-3b-a800m) when this band was set
FLOP_BAND = (0.75, 0.95)
# the same for a decode step, B = 2 over a cache of 256 positions: the softmax, the masks, RoPE
# and the norms over the cache are most of XLA's count; matmul share when this band was set:
# deepseek-v3-671b 0.520, granite-3-8b 0.406, granite-34b 0.487, granite-moe-3b-a800m 0.457,
# internvl2-76b 0.406, mamba2-780m 0.473, qwen1.5-110b 0.421, starcoder2-15b 0.396,
# whisper-tiny 0.331, zamba2-7b 0.328
DECODE_FLOP_BAND = (0.30, 0.55)
DECODE_CELLS = [(a, "decode_32k") for a in FAMILY_ARCHS] + [
    ("mamba2-780m", "long_500k"), ("zamba2-7b", "long_500k")]
GROWTH_REL = 0.05
F32_REL = 1e-4


def analytic(cfg, shape_id: str, mesh, fsdp: bool, batch: int = BATCH, seq: int = SEQ):
    rules = make_rules("tp", fsdp=fsdp)
    if shape_id == "train_4k":
        return TL.step_collectives(cfg, mesh, rules, batch, seq).summary()
    decode = shape_id in ("decode_32k", "long_500k")
    return dryrun.forward_collectives(cfg, mesh, rules, batch, seq, decode=decode).summary()


def decode_batch(shape_id: str) -> int:
    """``BATCH`` rows (8 a "data" rank), or long_500k's one row."""
    return 1 if shape_id == "long_500k" else BATCH


@pytest.mark.parametrize("shape_id", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_traced_collectives_equal_the_analytic_count(arch, shape_id):
    cfg = get_reduced_config(arch)
    got, meta = dryrun.lower_cell(cfg, shape_id, MESH24, batch=BATCH, seq=SEQ)
    assert meta["kind"] == shape_id.split("_")[0]
    assert got.collectives.summary() == analytic(cfg, shape_id, MESH24, meta["fsdp"])
    assert got.flops > 0 and got.peak_bytes > got.peak_by["state"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch, shape_id", DECODE_CELLS)
def test_traced_decode_collectives_equal_the_analytic_count(arch, shape_id):
    """A decode step over ``SEQ`` cache positions, 64 a "model" rank: the
    q/k/v gathers, the split softmax's max, sum and P·V partial, the Mamba2
    conv row, the TP sums and the logits gather, as counted."""
    cfg = get_reduced_config(arch)
    b = decode_batch(shape_id)
    got, meta = dryrun.lower_cell(cfg, shape_id, MESH24, batch=b, seq=SEQ)
    assert meta["kind"] == "decode"
    assert got.collectives.summary() == analytic(cfg, shape_id, MESH24, meta["fsdp"], b)
    assert got.flops > 0 and got.peak_bytes > got.peak_by["state"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b"])
def test_traced_collectives_with_fsdp(arch):
    """The TP rules with fsdp: the "data" split gathered for the step (and
    deepseek's expert leaves' moved onto their expert dim by all-to-all,
    Adafactor on the rank's experts)."""
    cfg = get_reduced_config(arch)
    if cfg.moe is not None:
        cfg = W.full_ep(cfg)
    got, _ = dryrun.lower_cell(cfg, "train_4k", MESH24, fsdp=True, batch=BATCH, seq=SEQ)
    want = analytic(cfg, "train_4k", MESH24, True)
    assert got.collectives.summary() == want and "all-gather" in want["by_op"]


def fit_config(arch: str):
    """The reduced config; whisper's decoder at 4 layers, above its first fit
    depth (2)."""
    cfg = get_reduced_config(arch)
    return dataclasses.replace(cfg, num_layers=4) if cfg.family == "audio" else cfg


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_depth_fit_extrapolates_to_the_full_depth_trace(arch):
    assert_fit_is_the_full_depth(arch, "train_4k")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_depth_fit_extrapolates_to_the_full_depth_trace(arch):
    assert_fit_is_the_full_depth(arch, "decode_32k")


def assert_fit_is_the_full_depth(arch: str, shape_id: str) -> None:
    cfg = fit_config(arch)
    got, meta = dryrun.lower_cell(cfg, shape_id, MESH24, batch=BATCH, seq=SEQ)
    fit = dryrun.depth_fit_analysis(cfg, shape_id, MESH24, meta["fsdp"], batch=BATCH, seq=SEQ)
    if cfg.family == "hybrid":
        la, lb = fit["depths"]
        assert la % cfg.attn_every == lb % cfg.attn_every == cfg.num_layers % cfg.attn_every
    assert fit["flops_per_dev"] == pytest.approx(got.flops, rel=1e-9)
    by_op = got.collectives.summary()["by_op"]
    assert sorted(fit["coll_by_op"]) == sorted(by_op)
    for k, v in by_op.items():
        assert fit["coll_by_op"][k] == pytest.approx(v["operand_bytes"], rel=1e-9), k


def layer_bytes(cfg, mesh, lay) -> tuple[int, int]:
    """(the rank's state bytes: the params' and the optimizer state's
    shards; the compute layout's copies: a leaf that ``relayout`` moves)."""
    def nbytes(d, spec):
        return math.prod(shard_shape(d.shape, spec, mesh)) * d.dtype.itemsize

    state = sum(nbytes(d, s) for d, s in zip(lay.param_defs + lay.opt_defs,
                                              lay.param_specs + lay.opt_specs))
    copies = sum(nbytes(d, c) for d, s, c in zip(lay.param_defs, lay.param_specs,
                                                  lay.compute_specs) if layout._plan(s, c)[0])
    return state, copies


@pytest.mark.parametrize("arch, depths", [("granite-3-8b", (2, 4)),
                                          ("deepseek-v3-671b", (5, 7))])
def test_peak_grows_by_the_layer_input_under_full_remat(arch, depths):
    """Full width on 16 x 16, train_4k (16 rows of 4096 tokens a rank): the
    peak grows between two depths by each added layer's input (a remat
    layer keeps nothing else) plus its state shards and compute copies.
    deepseek's two added layers are MoE layers (3 dense ones first); before
    the repair its Adafactor gathered every expert leaf whole (7.5 GB a MoE
    layer in bf16, three f32 transients of it), 45 GB a MoE layer."""
    base = get_config(arch)
    assert base.remat == "full"
    points = []
    for depth in depths:
        cfg = dataclasses.replace(base, num_layers=depth)
        got, meta = dryrun.lower_cell(cfg, "train_4k", SINGLE)
        lay = TL.MeshLayout(cfg, SINGLE, make_rules("tp", fsdp=meta["fsdp"]), 256, 4096)
        state, copies = layer_bytes(cfg, SINGLE, lay)
        assert got.peak_by["state"] == state
        points.append((got.peak_bytes, state + copies))
        layer_input = lay.local_batch * 4096 * cfg.d_model * cfg.dtype.itemsize
    added = depths[1] - depths[0]
    want = added * layer_input + points[1][1] - points[0][1]
    assert points[1][0] - points[0][0] == pytest.approx(want, rel=GROWTH_REL)


@pytest.fixture(scope="module")
def ref_flops(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("flops") / "flops.json")
    reference_run("flops", out, 1, str(FLOP_BATCH), str(FLOP_SEQ))
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", list_archs())
def test_traced_flops_against_the_reference_compiled_count(ref_flops, arch):
    cfg = dataclasses.replace(get_reduced_config(arch), scan_layers=False,
                              attention_impl="naive", remat="none")
    got, _ = dryrun.lower_cell(cfg, "train_4k", None, batch=FLOP_BATCH, seq=FLOP_SEQ)
    ratio = got.flops / ref_flops[arch]
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


@pytest.mark.parametrize("arch", list_archs())
def test_traced_decode_flops_against_the_reference_compiled_count(ref_flops, arch):
    cfg = dataclasses.replace(get_reduced_config(arch), scan_layers=False,
                              attention_impl="naive", remat="none")
    got, meta = dryrun.lower_cell(cfg, "decode_32k", None, batch=FLOP_BATCH, seq=FLOP_SEQ)
    assert meta["kind"] == "decode"
    ratio = got.flops / ref_flops[f"decode/{arch}"]
    assert DECODE_FLOP_BAND[0] <= ratio <= DECODE_FLOP_BAND[1], ratio


def test_a_decode_step_that_reads_a_value_raises(monkeypatch):
    """No fallback in the decode path: its attention reading a value of the
    positions (``.item()``) raises out of the cell, and the fake world is
    destroyed."""
    from torch._subclasses.fake_tensor import DataDependentOutputException

    from repro_torch.models import layers

    attend = layers.attention_decode

    def reads(q, k_cache, v_cache, pos, split=None):
        if int(pos.max().item()) < 0:
            raise AssertionError("unreachable")
        return attend(q, k_cache, v_cache, pos, split)

    monkeypatch.setattr(layers, "attention_decode", reads)
    with pytest.raises(DataDependentOutputException):
        dryrun.lower_cell(get_reduced_config("granite-3-8b"), "decode_32k", MESH24,
                          batch=BATCH, seq=SEQ)
    assert not dist.is_initialized()


def test_a_step_that_fails_under_fake_tensors_raises(monkeypatch):
    """No fallback: a data-dependent value (``.item()``) raises out of the
    cell, and the fake world is destroyed."""
    from torch._subclasses.fake_tensor import DataDependentOutputException

    def step(cfg, lay):
        return lambda params, opt_state, batch, i: batch["tokens"].sum().item()

    monkeypatch.setattr(TL, "make_mesh_step", step)
    with pytest.raises(DataDependentOutputException):
        dryrun.lower_cell(get_reduced_config("granite-3-8b"), "train_4k", MESH24,
                          batch=BATCH, seq=SEQ)
    assert not dist.is_initialized()


def test_the_fake_world_is_one_at_a_time():
    with fake_world(MESH24) as mesh:
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 2, "model": 4}
        with pytest.raises(RuntimeError, match="already started"):
            with fake_world(MESH24):
                pass
    assert not dist.is_initialized()


def test_live_bytes_count_a_storage_once_from_its_making_to_its_last_reference():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty(1000)

        def run(x):
            y = x * 2  # 4000 B
            z = y.view(10, 100) + 1  # 4000 B; the view is y's storage
            del y
            return torch.cat([z, z])  # 8000 B, z alive: the peak

        out, got = trace(run, a, state=[a])
    assert got.peak_bytes == 4000 + 4000 + 8000
    assert got.peak_by == {"state": 4000, "add": 4000, "cat": 8000}
    assert got.flops == 0 and got.collectives.summary()["by_op"] == {}
    assert out.shape == (20, 100)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("relayout")
    return run_world(W.relayout_main, 4, backend="gloo", init_file=str(root / "store"),
                     args=(str(root),))


def test_relayout_matches_the_whole_tensors_blocks(world):
    for r in world:
        for case, got in zip(W.RELAYOUT_CASES, r["relayout"]):
            assert got["equal"], case
            assert got["recorded"] == got["analytic"], case
    kinds = [set(g["recorded"]["by_op"]) for g in world[0]["relayout"]]
    assert kinds[0] == kinds[1] == kinds[2] == {"all-to-all"}


def test_mesh_trainer_under_fsdp_matches_the_mesh_without(world):
    """deepseek-v3-671b's reduced config (f32, the full config's expert
    axes) on 2 x 2 under the TP rules with fsdp: its expert leaves move onto
    their expert dim by all-to-all and Adafactor updates the rank's experts.
    Losses, gradient norms and each state leaf's norm as without fsdp (the
    same sharded MoE), every rank's collectives as counted."""
    for r in world:
        got, want = r["fsdp=True"], r["fsdp=False"]
        assert {"blocks/moe/wg", "blocks/moe/wu", "blocks/moe/wd"} <= set(
            got["moved_by_all_to_all"])
        for k in ("losses", "grad_norms", "state_norms"):
            np.testing.assert_allclose(got[k], want[k], rtol=F32_REL)
        for run in (got, want):
            assert run["recorded"] == run["analytic"]
