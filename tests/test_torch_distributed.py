"""The port's multi-device layer on the CPU: one spawned world of 8 gloo
ranks (``repro_torch.launch.world.run_world``, a ``FileStore`` under
``tmp_path``) runs every check of the port's side (``torch_dist_workers.
world_main``), while the reference runs the same weights and inputs in a JAX
subprocess on 8 forced host devices (``jax_reference_runs.py dist``); the
production meshes are built under torch's fake process group in one more
process.  Every world is joined or killed before its fixture returns.

Tolerances: the MoE, and the Trainer's losses, gradient norms and state
norms, are held to the reference's mesh runs in f32 (1e-4 relative; a
collective's reduction order is not XLA's, so sums across ranks agree to
f32 noise, not bit for bit); the MoE to the port's dense path as the
reference's own test holds its sharded MoE (> 95% of the elements within
5e-2 relative: capacity drops tokens), the dense Trainer to the port's
``mesh=None`` run in f32.  The exact data-parallel gradient is held to 1e-6
relative, the compressed one to one quantization step a rank of the
reference's compressed one (max scale / n) and to 2% of the exact mean, as
the reference's test requires; the Trainer with int8 gradients to the
reference's exact run as its test's docstring says."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config, list_archs
from repro_torch.launch.world import run_world
from repro_torch.models import moe
from repro_torch.models.model import init_model
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.sharding.rules import MeshShape, shard_shape, tensor_parallel_rules
from repro_torch.training import train_loop as TL

import torch_dist_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-4
STEPS, BATCH, SEQ = 4, 8, 32
# tensor-parallel blocks on 2 x 4: (kind, overrides of the reduced granite-3-8b
# in f32, the leaves a rank holds its "model" block of; the others whole)
TP_CASES = {
    "gqa_kv_whole": ("gqa", {"qkv_bias": True}, {"wq", "wo", "bq"}),  # 2 KV heads on 4 ranks
    "gqa_kv_split": ("gqa", {"num_heads": 8, "num_kv_heads": 4, "head_dim": 16},
                     {"wq", "wk", "wv", "wo"}),  # 2 q heads a rank on its one KV head
    "mlp_swiglu": ("mlp", {}, {"wg", "wu", "wd"}),
    "mlp_gelu": ("mlp", {"activation": "gelu"}, {"wi", "bi", "wo"}),
    "embed": ("embed", {}, {"tokens"}),
    "loss_padded_chunked": ("loss", {"vocab_size": 509, "logits_chunk": 8}, {"unembed"}),
    "loss_tied": ("loss", {"tie_embeddings": True}, {"tokens"}),
}
TP_BATCH, TP_SEQ = 2, 16


def tp_inputs() -> dict:
    """Each TP case's weights, input and cotangent (and labels, some masked),
    drawn with numpy; the leaves are the block's ParamDefs' (a loss case's,
    those its logits read)."""
    from repro_torch.models.layers import embed_defs, gqa_defs, mlp_defs

    rng = np.random.default_rng(1)
    data = {"tp/cases": np.asarray(json.dumps(list(TP_CASES)))}
    for case, (kind, over, _) in TP_CASES.items():
        cfg = dataclasses.replace(W.f32_config("granite-3-8b"), **over)
        defs = {"gqa": gqa_defs, "mlp": mlp_defs, "embed": embed_defs, "loss": embed_defs}[kind](cfg)
        if kind in ("embed", "loss"):  # the table the block reads
            keep = "unembed" if kind == "loss" and not cfg.tie_embeddings else "tokens"
            defs = {keep: defs[keep]}
        data[f"tp/{case}/kind"] = np.asarray(kind)
        data[f"tp/{case}/overrides"] = np.asarray(json.dumps(over))
        for k, d in defs.items():
            fan_in = d.shape[0] if len(d.shape) >= 2 else 10.0  # biases at 0.3
            data[f"tp/{case}/p/{k}"] = (rng.standard_normal(d.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        act = (TP_BATCH, TP_SEQ, cfg.d_model)
        if kind == "embed":
            data[f"tp/{case}/x"] = rng.integers(0, cfg.vocab_size, act[:2]).astype(np.int32)
        else:
            data[f"tp/{case}/x"] = rng.standard_normal(act).astype(np.float32)
        if kind == "loss":
            labels = rng.integers(0, cfg.vocab_size, act[:2]).astype(np.int32)
            labels[:, ::5] = -1
            data[f"tp/{case}/labels"] = labels
            data[f"tp/{case}/cot"] = np.asarray(1.0, np.float32)
        else:
            data[f"tp/{case}/cot"] = rng.standard_normal(act).astype(np.float32)
    return data


def reference_inputs() -> dict:
    rng = np.random.default_rng(0)
    cfg = get_reduced_config("granite-moe-3b-a800m")
    data = {}
    for k, d in moe.moe_defs(cfg).items():
        scale = 1.0 / np.sqrt(d.shape[-2]) if len(d.shape) >= 2 else 1.0
        data[f"moe/{k}"] = (rng.standard_normal(d.shape) * scale).astype(np.float32)
    for case, shape in (("a2a", (4, 64)), ("a2a_split", (4, 128)), ("gather", (8, 1))):
        data[f"moe/x_{case}"] = rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)
    data["dp/w"] = rng.standard_normal((32, 16)).astype(np.float32)
    data["dp/x"] = rng.standard_normal((64, 32)).astype(np.float32)
    data["dp/y"] = rng.standard_normal((64, 16)).astype(np.float32)
    data["train/steps"], data["train/batch"], data["train/seq"] = (
        np.asarray(STEPS), np.asarray(BATCH), np.asarray(SEQ))
    for arch in W.TRAIN_ARCHS:
        cfg = get_reduced_config(arch)
        params = init_model(cfg, torch.Generator().manual_seed(1), "cpu")
        for i, t in enumerate(tree_flatten(params)):
            data[f"train/{arch}/{i}"] = t.float().numpy()
    return data | tp_inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    in_path, ref_path = str(root / "in.npz"), str(root / "ref.npz")
    np.savez(in_path, **reference_inputs())
    env = dict(os.environ, XLA_FLAGS=W.REFERENCE_XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "jax_reference_runs.py"), "dist",
         in_path, ref_path], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_world(W.world_main, 8, backend="gloo", init_file=str(root / "store"),
                          args=(in_path, str(root)), timeout_s=300)
        out, err = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return {"ranks": ranks, "ref": dict(np.load(ref_path)), "data": dict(np.load(in_path)),
            "root": str(root)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def dense_match(got, want) -> float:
    r = np.abs(got - want) / (np.abs(want) + 1e-3)
    return float((r < 5e-2).mean())


# ---------------------------------------------------------------------------
# the sharded MoE on 2 x 4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case, mode, tp_split",
                         [("a2a", "a2a", 1), ("a2a_split", "a2a", 4), ("gather", "gather", 1)])
def test_moe_sharded_matches_the_reference_and_the_dense_oracle(runs, case, mode, tp_split):
    got = runs["ranks"][0]["moe"][case]
    assert (got["mode"], got["tp_split"]) == (mode, tp_split)
    for r in runs["ranks"][1:]:  # every rank gathered the same whole y
        np.testing.assert_array_equal(r["moe"][case]["y"], got["y"])
    ref_y, ref_aux = runs["ref"][f"moe/{case}/y"], runs["ref"][f"moe/{case}/aux"]
    assert rel(got["y"], ref_y) < F32_REL
    assert abs(got["aux"] - float(ref_aux)) <= F32_REL * abs(float(ref_aux))
    cfg = get_reduced_config("granite-moe-3b-a800m")
    data = runs["data"]
    params = {k: torch.from_numpy(data[f"moe/{k}"]) for k in ("router", "wg", "wu", "wd")}
    y_dense, _ = moe.moe_apply(params, torch.from_numpy(data[f"moe/x_{case}"]), cfg)
    frac = dense_match(got["y"], y_dense.numpy())
    assert frac > 0.95, frac
    if mode == "gather":  # no capacity: the dense result, up to f32 sums
        assert rel(got["y"], y_dense.numpy()) < F32_REL


@pytest.mark.parametrize("case", ["a2a", "gather"])
def test_moe_sharded_with_int8_experts_matches_the_dense_int8_layer(runs, case):
    """Each rank's block of the quantized experts (payload and scales): the
    sharded layer against the port's dense int8 layer (the expert FFN of
    each rank one batched ``int8_matmul`` call, its plain version here)."""
    from repro_torch.models.quant import quantize_weight

    cfg = get_reduced_config("granite-moe-3b-a800m")
    data = runs["data"]
    params = {k: torch.from_numpy(data[f"moe/{k}"]) for k in ("router", "wg", "wu", "wd")}
    for k in ("wg", "wu", "wd"):
        params[k] = quantize_weight(params[k], lead=1, n_contract=1)
    y_dense, _ = moe.moe_apply(params, torch.from_numpy(data[f"moe/x_{case}"]), cfg)
    got = runs["ranks"][0]["moe"][f"int8_{case}"]
    assert dense_match(got, y_dense.numpy()) > 0.95
    if case == "gather":
        assert rel(got, y_dense.numpy()) < F32_REL


@pytest.mark.parametrize("case", W.MOE_CASES)
def test_moe_collectives_recorded_equal_the_analytic_count(runs, case):
    for r in runs["ranks"]:
        got = r["moe"][case]
        assert got["recorded"] == got["analytic"]
        assert got["recorded"]["total_bytes"] > 0


# ---------------------------------------------------------------------------
# tensor-parallel compute on 2 x 4: each block on the rank's "model" shards
# ---------------------------------------------------------------------------
def model_block(a: np.ndarray, spec: list, m: int) -> np.ndarray:
    """The block of ``a`` at coordinate ``m`` of the 4 "model" ranks."""
    for dim, e in enumerate(spec):
        if e == "model":
            n = a.shape[dim] // 4
            a = np.take(a, range(m * n, (m + 1) * n), axis=dim)
    return a


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_block_matches_the_reference_one_device_function(runs, case):
    """The block's output, its input's gradient and each leaf's gradient
    block on every rank against the reference's function on one device, the
    same numpy weights and cotangent; and which leaves the rank held its
    block of (wk and wv whole where 2 KV heads do not divide 4 ranks)."""
    ref = runs["ref"]
    for rank, r in enumerate(runs["ranks"]):
        got, m = r["tp"][case], rank % 4
        assert {k for k, sp in got["specs"].items() if "model" in sp} == TP_CASES[case][2]
        assert rel(got["y"], ref[f"tp/{case}/y"]) < F32_REL
        if TP_CASES[case][0] != "embed":
            assert rel(got["dx"], ref[f"tp/{case}/dx"]) < F32_REL
        for k, g in got["grads"].items():
            want = model_block(ref[f"tp/{case}/d/{k}"], got["specs"][k], m)
            assert g.shape == want.shape and rel(g, want) < F32_REL, k


@pytest.mark.parametrize("arch", list_archs())
def test_compute_specs_keep_model_on_the_tp_leaves(arch):
    """Under the TP rules with fsdp on 16 x 16, every family (the GQA and
    MLA stacks, Mamba2, hybrid's shared block, whisper's encoder and
    decoder) computes every non-expert leaf on its "model" block wherever
    its storage splits it over "model" and gathers only the "data" split.
    The expert leaves take the MoE's expert axes."""
    cfg = get_config(arch)
    mesh = MeshShape({"data": 16, "model": 16})
    lay = TL.MeshLayout(cfg, mesh, tensor_parallel_rules(fsdp=True), 256, 4096)
    split = 0
    for path, store, c in zip(lay.paths, lay.param_specs, lay.compute_specs):
        if path[-2:-1] == ("moe",) and path[-1] in ("wg", "wu", "wd"):
            continue
        assert c == tuple("model" if e == "model" else None for e in store), path
        split += "model" in c
    assert split > 0


@pytest.mark.parametrize("arch, mesh, batch, seq", [
    ("granite-3-8b", (2, 4), BATCH, SEQ), ("granite-moe-3b-a800m", (2, 4), BATCH, SEQ),
    ("internvl2-76b", (2, 4), BATCH, SEQ), ("deepseek-v3-671b", (2, 4), BATCH, SEQ),
    ("mamba2-780m", (2, 4), BATCH, SEQ), ("zamba2-7b", (2, 4), BATCH, SEQ),
    ("whisper-tiny", (2, 4), BATCH, SEQ), ("granite-3-8b/full", (2, 2), 4, 512)])
def test_analytic_step_gathers_only_the_fsdp_split(arch, mesh, batch, seq):
    """The analytic step's all-gathers under the TP rules with fsdp are the
    "data" gathers of the fsdp split alone, one a leaf split over "data"
    (its block's bytes): nothing is gathered over "model".  The reduced
    configs on 2 x 4 (deepseek under AdamW: its pinned Adafactor gathers
    every leaf whole for its update, ``train_loop._adafactor_on_mesh``);
    granite-3-8b at full width, 2 layers, on 2 x 2 (the card's multi-device
    step)."""
    name, full = arch.split("/")[0], arch.endswith("/full")
    cfg = (dataclasses.replace(get_config(name), num_layers=2) if full
           else dataclasses.replace(get_reduced_config(name), optimizer="adamw"))
    mesh = MeshShape(dict(zip(("data", "model"), mesh)))
    rules = tensor_parallel_rules(fsdp=True)
    stats = TL.step_collectives(cfg, mesh, rules, batch, seq)
    lay = TL.MeshLayout(cfg, mesh, rules, batch, seq)
    fsdp = [(d, sp) for d, sp in zip(lay.param_defs, lay.param_specs) if "data" in sp]
    assert fsdp and stats.counts["all-gather"] == len(fsdp)
    assert stats.operand_bytes["all-gather"] == sum(
        math.prod(shard_shape(d.shape, sp, mesh)) * d.dtype.itemsize for d, sp in fsdp)


@pytest.mark.parametrize("arch", W.TRAIN_ARCHS)
def test_mesh_trainer_first_draws_are_the_whole_draws_blocks(runs, arch):
    """The mesh Trainer draws its state leaf by leaf, keeping its blocks: the
    same bits as the blocks of the whole draw, both optimizers."""
    for r in runs["ranks"]:
        for opt in ("adamw", "adafactor"):
            got = r["first_draws"][f"{arch}/{opt}"]
            assert all(got["equal"]) and got["split"] > 0


# ---------------------------------------------------------------------------
# the data-parallel gradient, exact and int8-compressed, on 8 x 1
# ---------------------------------------------------------------------------
def test_exact_dp_gradient_matches_the_reference(runs):
    ref = runs["ref"]
    for r in runs["ranks"]:
        assert abs(r["dp"]["exact"]["loss"] - float(ref["dp/exact/loss"])) <= 1e-6 * abs(
            float(ref["dp/exact/loss"]))
        assert rel(r["dp"]["exact"]["g"], ref["dp/exact/g"]) < 1e-6


def test_compressed_dp_gradient_within_a_quantization_step(runs):
    ref = runs["ref"]
    step = max(r["dp"]["scale"] for r in runs["ranks"]) / 8
    for r in runs["ranks"]:
        g = r["dp"]["compressed"]["g"]
        assert np.abs(g - ref["dp/compressed/g"]).max() <= step
        assert rel(g, r["dp"]["exact"]["g"]) < 0.02
        assert abs(r["dp"]["compressed"]["loss"] - r["dp"]["exact"]["loss"]) < 1e-5
    np.testing.assert_array_equal(runs["ranks"][3]["dp"]["compressed"]["g"],
                                  runs["ranks"][0]["dp"]["compressed"]["g"])


# ---------------------------------------------------------------------------
# elastic restore onto 4 x 2 (the reference's test_elastic_checkpoint_restore_onto_mesh)
# ---------------------------------------------------------------------------
def test_elastic_checkpoint_restore_onto_mesh(runs):
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    for rank, r in enumerate(runs["ranks"]):
        got = r["elastic"]
        assert got["step"] == 1 and got["is_dtensor"]
        assert got["w_placements"] == ["S(0)", "S(1)"]
        d, m = divmod(rank, 2)  # row-major coordinates on ("data", "model")
        np.testing.assert_array_equal(got["w_local"], w[2 * d:2 * d + 2, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(got["b_local"], np.ones(4, np.float32))
        np.testing.assert_array_equal(got["w_full"], w)


# ---------------------------------------------------------------------------
# the Trainer on 2 x 4
# ---------------------------------------------------------------------------
def one_device_trainer(runs, arch, **tc):
    cfg, ds, leaves = W.train_setup(runs["data"], arch)
    tc = TL.TrainerConfig(num_steps=STEPS, log_every=1, checkpoint_every=1000, **tc)
    return W.numpy_trainer(leaves)(cfg, ds, tc, device="cpu")


def assert_same_run(got: dict, ref, prefix: str) -> None:
    """Losses, each step's gradient norm and each state leaf's norm at the
    end, at f32 tolerance.  The norms see what the losses do not: AdamW and
    Adafactor divide a leaf's gradient by its own running scale and the
    clip is one global factor, so a gradient scaled wrongly (a sum or
    divisor off, a block counted twice in the norm) leaves the losses
    alone but not the gradient norm or the moments."""
    np.testing.assert_allclose(got["losses"], ref[f"{prefix}/losses"], rtol=F32_REL)
    np.testing.assert_allclose(got["grad_norms"], ref[f"{prefix}/grad_norms"], rtol=F32_REL)
    np.testing.assert_allclose(got["state_norms"], ref[f"{prefix}/state_norms"], rtol=F32_REL)


def one_device_run(runs, arch, directory: str) -> dict:
    tr = one_device_trainer(runs, arch, checkpoint_dir=directory)
    rows = tr.run()["metrics"]
    return {"losses": [m["loss"] for m in rows], "grad_norms": [m["grad_norm"] for m in rows],
            "state_norms": W.state_norms(tr)}


@pytest.mark.parametrize("arch", W.TRAIN_ARCHS)
def test_trainer_on_mesh_matches_the_reference_mesh_run(runs, arch, tmp_path):
    for r in runs["ranks"]:
        got = r[arch]
        assert len(got["losses"]) == STEPS
        assert_same_run(got, runs["ref"], f"train/{arch}")
        # a failure at the last step restored step 2's checkpoint and replayed it;
        # rank 0's straggler at step 1 made every rank snapshot
        assert got["restarts"] == 1
        assert got["checkpoints"] == ["step_000001", "step_000002", "step_000003"]
    if arch == "granite-3-8b":  # dense: the port's own one-device run
        assert_same_run(one_device_run(runs, arch, str(tmp_path)), runs["ref"], f"train/{arch}")


def test_trainer_with_int8_gradients_against_the_exact_reference_run(runs):
    """The Trainer on 2 x 4 with ``grad_compress`` (the int8 all-reduce over
    "data") for every step, against the reference's exact mesh run.  Steps 0
    and 1 start from the reference's state (the schedule's lr is 0 at step
    0, checked in both runs): their losses are the exact run's, and their
    gradient norms are within the bound the reference's run gives on the
    int8 mean's distance from the exact mean (half the largest rank's scale
    an entry).  Every step's loss is within 2% of the exact run's, the
    reference's rule for the compressed mean.  From step 2 on the compressed
    updates have moved the parameters (Adam's step is about lr a moved
    entry whatever the gradient's size), so the gradient norms are no
    longer the exact run's; they are the same on every rank."""
    ref = runs["ref"]
    prefix = "train/granite-3-8b"
    want_loss, want_norm = ref[f"{prefix}/losses"], ref[f"{prefix}/grad_norms"]
    assert float(ref[f"{prefix}/lrs"][0]) == 0.0
    for r in runs["ranks"]:
        got = r["granite-3-8b"]["compressed"]
        assert len(got["losses"]) == STEPS and got["lrs"][0] == 0.0
        np.testing.assert_allclose(got["losses"][:2], want_loss[:2], rtol=F32_REL)
        for step, bound in enumerate(ref[f"{prefix}/int8_bounds"]):
            assert abs(got["grad_norms"][step] - want_norm[step]) <= (
                float(bound) + F32_REL * want_norm[step]), step
        np.testing.assert_allclose(got["losses"], want_loss, rtol=0.02)
        assert all(np.isfinite(got["grad_norms"]))
        assert got["grad_norms"] == runs["ranks"][0]["granite-3-8b"]["compressed"]["grad_norms"]


@pytest.mark.parametrize("arch", W.TRAIN_ARCHS)
def test_trainer_collectives_recorded_equal_the_analytic_count(runs, arch):
    for r in runs["ranks"]:
        assert r[arch]["recorded"] == r[arch]["analytic"]
    if arch == "granite-3-8b":
        for r in runs["ranks"]:
            comp = r[arch]["compressed"]
            assert comp["recorded"] == comp["analytic"]
            assert comp["recorded"]["by_op"]["all-gather"]["count"] > 0


def test_adafactor_on_mesh_matches_one_device(runs, tmp_path):
    """Adafactor on 2 x 4 (the moments from the whole gradient, each rank
    keeping its shard) against two steps on one device; its step's
    collectives as counted."""
    cfg, ds, leaves = W.train_setup(runs["data"], "granite-3-8b")
    want = W.adafactor_steps(cfg, ds, leaves, None, str(tmp_path))
    for r in runs["ranks"]:
        got = r["granite-3-8b"]["adafactor"]
        for k in ("losses", "grad_norms", "state_norms"):
            np.testing.assert_allclose(got[k], want[k], rtol=F32_REL)
        assert got["recorded"] == got["analytic"]


def test_mesh_checkpoint_restores_on_one_device_and_on_4x2(runs):
    """The 2 x 4 run's final checkpoint (written from the mesh by rank 0),
    restored onto a 4 x 2 mesh and onto one device: the next step's loss is
    the 2 x 4 Trainer's own next step."""
    arch = "granite-3-8b"
    r0 = runs["ranks"][0][arch]
    tr = one_device_trainer(runs, arch, checkpoint_dir=os.path.join(runs["root"], arch))
    tr.tc = dataclasses.replace(tr.tc, num_steps=STEPS + 1)
    start = tr._restore()
    assert start == STEPS
    _, _, metrics = tr.step_fn(tr.params, tr.opt_state, tr.batch(start), start)
    for r in runs["ranks"]:
        got = r[arch]["restored_42"]
        assert got["start"] == STEPS
        assert got["loss"] == pytest.approx(r0["next_loss"], rel=F32_REL)
        assert got["grad_norm"] == pytest.approx(r0["next_grad_norm"], rel=F32_REL)
    assert float(metrics["loss"]) == pytest.approx(r0["next_loss"], rel=F32_REL)
    assert float(metrics["grad_norm"]) == pytest.approx(r0["next_grad_norm"], rel=F32_REL)


# ---------------------------------------------------------------------------
# the production meshes under the fake process group
# ---------------------------------------------------------------------------
def test_production_mesh_construction():
    proc = subprocess.run(
        [sys.executable, "-c", "import json, torch_dist_workers as W; "
                               "print(json.dumps(W.fake_meshes()))"],
        capture_output=True, text=True, timeout=120, cwd=os.path.dirname(__file__),
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(REPO, "src"), os.path.dirname(__file__)])))
    assert proc.returncode == 0, proc.stderr
    import json

    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["512/single"] == {"shape": [16, 16], "names": ["data", "model"]}
    assert got["512/multi"] == {"shape": [2, 16, 16], "names": ["pod", "data", "model"]}
    assert got["256/single"] == {"shape": [16, 16], "names": ["data", "model"]}
    assert "needs 512 ranks, the world has 256" in got["256/multi"]["error"]
    assert "needs 256 ranks, the world has 100" in got["100/single"]["error"]
    assert got["100/host"] == {"shape": [1, 100], "names": ["data", "model"]}


def test_one_rank_mesh_moe_is_the_dense_path():
    from repro_torch.sharding.rules import MeshShape, activate_mesh

    cfg = get_reduced_config("granite-moe-3b-a800m")
    params = tree_map(lambda t: t.float(), W.params_from_numpy(
        {k: np.asarray(v) for k, v in reference_inputs().items() if k.startswith("moe/")}, "cpu"))
    p = {k: params[f"moe/{k}"] for k in ("router", "wg", "wu", "wd")}
    x = params["moe/x_a2a"]
    with activate_mesh(MeshShape({"data": 1, "model": 1})):
        assert all(torch.equal(a, b) for a, b in zip(moe.moe_apply(p, x, cfg),
                                                     moe._moe_dense(p, x, cfg)))
