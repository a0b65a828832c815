"""Tensor-parallel compute of the MLA, Mamba2, hybrid and whisper families
on the CPU: one spawned world of 8 gloo ranks on a 2 x 4 mesh
(``torch_dist_workers.tp_world_main``) runs each family's blocks on the
rank's "model" shards, each family's decode step on the rank's blocks of
its params and of a cache split over "model" on its positions
(flash-decoding), and the mesh Trainer of the four reduced archs, while
the reference runs the same weights and inputs in a JAX subprocess on 8
forced host devices (``jax_reference_runs.py tp``).  It runs beside
``test_torch_distributed.py`` (each file is one world and one subprocess).

Tolerances (f32): every block's output, input gradients and each leaf's
gradient block on every rank against the reference's one-device function,
and the Trainer's losses, gradient norms and state norms against the
reference's mesh run, at 1e-4 relative: a collective's reduction order is
not XLA's, so sums across ranks agree to f32 noise, not bit for bit; the
mesh decode step's logits and every rank's block of the cache it returns
against the reference's one-device ``decode_step``, at 1e-4 too.  An
attention key bias's gradient is exactly 0 (softmax ignores a shift common
to a query's scores): rounding noise, held to 1e-6 of the case's largest
gradient, as ``test_torch_train_loss`` holds it (the state norms:
``assert_state_norms``).  The reference's chunked SSD scan has NaN
gradients (``test_torch_train_loss`` pins that), so its runs here mask the
scan's exp as the port does (``jax_reference_runs.masked_ssd``); whisper's
reference run takes the port's front-end frames (drawn by torch, where the
reference draws with ``jax.random``).  The recorded collectives equal
``step_collectives`` byte for byte.  The layout arithmetic (which leaves
split, the bytes a rank holds for the step, the counted sums) needs no
world."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import collectives as C
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import dryrun
from repro_torch.launch.world import run_world
from repro_torch.models.model import init_model
from repro_torch.models.params import tree_flatten
from repro_torch.serving.kv_cache import cache_defs
from repro_torch.sharding.rules import (
    MeshShape,
    entry_axes,
    shard_shape,
    spec_for,
    tensor_parallel_rules,
)
from repro_torch.training import train_loop as TL

import torch_dist_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-4
ZERO_GRAD_TOL = 1e-6  # of the case's largest gradient, for a leaf whose gradient is 0
STEPS, BATCH, SEQ = 3, 8, 32
TP_BATCH, TP_SEQ, ENC_SEQ = 2, 16, 24
ATTN = ("wq", "wk", "wv", "wo")
BIAS_ATTN = ATTN + ("bq", "bk", "bv")
# (kind, arch, overrides of its reduced config in f32, extra input, the leaves a rank holds its
# "model" block of on 2 x 4; the others whole)
TP_CASES = {
    "mla": ("mla", "deepseek-v3-671b", {}, None, {"wq_b", "wk_b", "wv_b", "wo"}),
    "shared_experts": ("shared_experts", "deepseek-v3-671b", {}, None, {"wg", "wu", "wd"}),
    # 8 heads, 2 a rank, the scan over two chunks of 8
    "mamba": ("mamba", "mamba2-780m", {"ssm": {"chunk_size": 8}}, None,
              {"wz", "wx", "wdt", "conv_x", "conv_x_b", "A_log", "dt_bias", "D", "wo"}),
    # d_inner 128 divides 4, its 2 heads of 64 do not: the block computes whole
    "mamba_heads_whole": ("mamba", "mamba2-780m", {"ssm": {"head_dim": 64}}, None, set()),
    "shared_block": ("shared_attn", "zamba2-7b", {}, "x0",
                     {f"attn/{k}" for k in ATTN} | {"mlp/wg", "mlp/wu", "mlp/wd"}),
    "enc_block": ("enc_block", "whisper-tiny", {}, None,
                  {f"attn/{k}" for k in BIAS_ATTN} | {"mlp/wi", "mlp/bi", "mlp/wo"}),
    "dec_block": ("dec_block", "whisper-tiny", {}, "enc",
                  {f"{a}/{k}" for a in ("self_attn", "cross_attn") for k in BIAS_ATTN}
                  | {"mlp/wi", "mlp/bi", "mlp/wo"}),
    "cross_attn": ("cross_attn", "whisper-tiny", {}, "enc", set(BIAS_ATTN)),
}
TRAIN_ARCHS = ("deepseek-v3-671b", "mamba2-780m", "zamba2-7b", "whisper-tiny")
# one arch a family; the cache's 32 positions 8 a "model" rank: at position 3 ranks 1-3 hold only
# masked rows, at 21 the new row is written by rank 2
DECODE_ARCHS = ("granite-3-8b", "internvl2-76b", "granite-moe-3b-a800m", "deepseek-v3-671b",
                "mamba2-780m", "zamba2-7b", "whisper-tiny")
DECODE_BATCH, DECODE_CAPACITY, DECODE_POSITIONS = 2, 32, (3, 21)


def tp_inputs() -> dict:
    """Each case's weights, input x, extra input e (hybrid's x0, whisper's
    encoder output over ``ENC_SEQ`` frames) and cotangent, drawn with
    numpy; the leaves are the block's ParamDefs', named by key path."""
    rng = np.random.default_rng(2)
    data = {"tp/cases": np.asarray(json.dumps(list(TP_CASES)))}
    for case, (kind, arch, over, extra, _) in TP_CASES.items():
        data[f"tp/{case}/kind"], data[f"tp/{case}/arch"] = np.asarray(kind), np.asarray(arch)
        data[f"tp/{case}/overrides"] = np.asarray(json.dumps(over))
        cfg = W.case_config(data, case)
        for k, d in W.flat_defs(W.TP_KINDS[kind][0](cfg)).items():
            fan_in = d.shape[0] if len(d.shape) >= 2 else 10.0  # biases and vectors at 0.3
            data[f"tp/{case}/p/{k}"] = (rng.standard_normal(d.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        act = (TP_BATCH, TP_SEQ, cfg.d_model)
        data[f"tp/{case}/x"] = rng.standard_normal(act).astype(np.float32)
        if extra is not None:
            rows = ENC_SEQ if extra == "enc" else TP_SEQ
            data[f"tp/{case}/e"] = rng.standard_normal((TP_BATCH, rows, cfg.d_model)).astype(
                np.float32)
        data[f"tp/{case}/cot"] = rng.standard_normal(act).astype(np.float32)
    return data


def decode_inputs() -> dict:
    """Each decode arch's params (``init_model``'s draw, in f32, leaves in
    ``tree_flatten`` order), a whole cache drawn with numpy and one token a
    row."""
    rng = np.random.default_rng(4)
    data = {"decode/archs": np.asarray(json.dumps(DECODE_ARCHS)),
            "decode/capacity": np.asarray(DECODE_CAPACITY),
            "decode/positions": np.asarray(DECODE_POSITIONS)}
    for arch in DECODE_ARCHS:
        cfg = W.f32_config(arch)
        params = init_model(cfg, torch.Generator().manual_seed(1), "cpu")
        for i, t in enumerate(tree_flatten(params)):
            data[f"decode/{arch}/p/{i}"] = t.float().numpy()
        for k, d in cache_defs(cfg, batch=DECODE_BATCH, max_len=DECODE_CAPACITY).items():
            data[f"decode/{arch}/cache/{k}"] = rng.standard_normal(d.shape).astype(np.float32)
        data[f"decode/{arch}/token"] = rng.integers(0, cfg.vocab_size, (DECODE_BATCH, 1)).astype(
            np.int32)
    return data


def reference_inputs() -> dict:
    data = {"train/archs": np.asarray(json.dumps(TRAIN_ARCHS)), "train/steps": np.asarray(STEPS),
            "train/batch": np.asarray(BATCH), "train/seq": np.asarray(SEQ)}
    for arch in TRAIN_ARCHS:
        params = init_model(get_reduced_config(arch), torch.Generator().manual_seed(1), "cpu")
        for i, t in enumerate(tree_flatten(params)):
            data[f"train/{arch}/{i}"] = t.float().numpy()
        cfg, ds, _ = W.train_setup(data, arch)
        if cfg.frontend is not None:  # the port's stubs: the reference's run takes these
            for step in range(STEPS):
                data[f"train/{arch}/frames/{step}"] = make_batch(cfg, ds, step, device="cpu")[
                    "frontend_embeds"].numpy()
    return data | tp_inputs() | decode_inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_tp")
    in_path, ref_path = str(root / "in.npz"), str(root / "ref.npz")
    np.savez(in_path, **reference_inputs())
    env = dict(os.environ, XLA_FLAGS=W.REFERENCE_XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "jax_reference_runs.py"), "tp",
         in_path, ref_path], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_world(W.tp_world_main, 8, backend="gloo", init_file=str(root / "store"),
                          args=(in_path, str(root)), timeout_s=400)
        out, err = jax_proc.communicate(timeout=400)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return {"ranks": ranks, "ref": dict(np.load(ref_path))}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def model_block(a: np.ndarray, spec: list, m: int, d: int = 0) -> np.ndarray:
    """The block of ``a`` at coordinate ``m`` of the 4 "model" ranks (and
    ``d`` of the 2 "data" ranks)."""
    for dim, e in enumerate(spec):
        if e in ("model", "data"):
            k = {"model": 4, "data": 2}[e]
            c = m if e == "model" else d
            n = a.shape[dim] // k
            a = np.take(a, range(c * n, (c + 1) * n), axis=dim)
    return a


# ---------------------------------------------------------------------------
# each family's blocks on the rank's "model" shards, against one device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", TP_CASES)
def test_tp_block_matches_the_reference_one_device_function(runs, case):
    """The block's output, its inputs' gradients and each leaf's gradient
    block on every rank against the reference's function on one device;
    and which leaves the rank held its block of (MLA's wq_a, wkv_a and
    norms whole; Mamba2's B/C projections, convs and norm whole, with the
    norm's mean of squares summed across the ranks; the shared block's w_in
    and w_out whole; whisper's K/V heads from the encoder output)."""
    ref = runs["ref"]
    for rank, r in enumerate(runs["ranks"]):
        got, m = r["tp"][case], rank % 4
        assert {k for k, sp in got["specs"].items() if "model" in sp} == TP_CASES[case][4]
        assert rel(got["y"], ref[f"tp/{case}/y"]) < F32_REL
        assert rel(got["dx"], ref[f"tp/{case}/dx"]) < F32_REL
        if TP_CASES[case][3] is not None:
            assert rel(got["de"], ref[f"tp/{case}/de"]) < F32_REL
        assert got["grads"].keys() == {k[len(f"tp/{case}/d/"):] for k in ref
                                       if k.startswith(f"tp/{case}/d/")}
        top = max(float(np.abs(ref[k]).max()) for k in ref if k.startswith(f"tp/{case}/d/"))
        for k, g in got["grads"].items():
            want = model_block(ref[f"tp/{case}/d/{k}"], got["specs"][k], m)
            assert g.shape == want.shape, k
            if k.split("/")[-1] == "bk":  # exactly 0: softmax ignores a shift of a query's scores
                assert np.abs(g - want).max() <= ZERO_GRAD_TOL * top, k
            else:
                assert rel(g, want) < F32_REL, k


# ---------------------------------------------------------------------------
# each family's decode step on the rank's blocks of a kv_seq-split cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pos", DECODE_POSITIONS)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_decode_matches_the_reference_one_device_step(runs, arch, pos):
    """The logits of the rank's rows (every vocabulary column) and the
    rank's block of each cache leaf after the step against the reference's
    one-device ``decode_step``: the new K/V rows written only by the rank
    whose slice holds ``pos``, Mamba2's whole conv window on every rank,
    its state on the rank's heads."""
    ref = runs["ref"]
    pre = f"decode/{arch}/{pos}/"
    for rank, r in enumerate(runs["ranks"]):
        got, m, d = r["decode"][arch], rank % 4, rank // 4
        logits = got[pos]["logits"]
        want = ref[pre + "logits"]
        rows = logits.shape[0]
        assert logits.shape == (rows, want.shape[1])
        assert rel(logits, want[d * rows:(d + 1) * rows]) < F32_REL
        assert set(got[pos]["cache"]) == {k[len(pre + "cache/"):] for k in ref
                                          if k.startswith(pre + "cache/")}
        for k, c in got[pos]["cache"].items():
            block = model_block(ref[pre + "cache/" + k], got["specs"][k], m, d)
            assert c.shape == block.shape, k
            assert rel(c, block) < F32_REL, k


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_decode_sends_what_the_dry_run_counts(runs, arch):
    """What each rank's decode step sent over the gloo world equals
    ``dryrun.forward_collectives(decode=True)``; the cache's positions are
    split over "model" for every family with an attention cache (whisper's
    cross K/V too: 32 frames at this size)."""
    cfg = W.f32_config(arch)
    want = dryrun.forward_collectives(cfg, MeshShape({"data": 2, "model": 4}),
                                      tensor_parallel_rules(), DECODE_BATCH, DECODE_CAPACITY,
                                      decode=True, dtype=torch.float32).summary()
    for r in runs["ranks"]:
        got = r["decode"][arch]
        for pos in DECODE_POSITIONS:
            assert got[pos]["recorded"] == want
        split = {k for k, sp in got["specs"].items() if "model" in sp}
        assert split == {k for k in got["specs"] if k not in ("conv",)}


def test_decode_bodies_refuse_a_split_they_cannot_use():
    """No fallback: a GQA cache split on its KV heads, and a Mamba2 conv
    window split on its channels (its spec keeps it whole), raise."""
    from repro_torch.models import layers, ssm
    from repro_torch.models.params import init_params

    gen = torch.Generator().manual_seed(0)
    cfg = W.f32_config("granite-3-8b")
    p = init_params(layers.gqa_defs(cfg), gen, "cpu")
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    cache = torch.zeros((1, 8, kv // 2, hd))
    with pytest.raises(ValueError, match="whole heads"):
        layers.gqa_decode_apply(p, torch.zeros((1, 1, cfg.d_model)), cache, cache.clone(),
                                torch.zeros(1, dtype=torch.int64), cfg)
    cfg = W.f32_config("mamba2-780m")
    p = init_params(ssm.mamba_defs(cfg), gen, "cpu")
    s = cfg.ssm
    conv = torch.zeros((1, s.conv_width - 1, ssm.conv_channels(cfg) // 2))
    state = torch.zeros((1, s.num_heads(cfg.d_model), s.head_dim, s.state_size))
    with pytest.raises(ValueError, match="conv cache is whole"):
        ssm.mamba_decode_apply(p, torch.zeros((1, 1, cfg.d_model)), conv, state, cfg)


def test_mamba_heads_that_do_not_divide_model_compute_whole():
    """mamba2-780m under 32-way "model": its 3072 d_inner columns divide, its
    48 heads do not (96 columns a rank would be 1.5 heads).  The storage
    splits the ``inner`` leaves; the step computes every leaf of the block
    whole, as ``spec_for`` computes whole KV heads that do not divide."""
    cfg = get_config("mamba2-780m")
    mesh = MeshShape({"data": 8, "model": 32})
    rules = tensor_parallel_rules(fsdp=True)
    lay = TL.MeshLayout(cfg, mesh, rules, 64, 4096)
    mamba = [(p, s, c) for p, s, c in zip(lay.paths, lay.param_specs, lay.compute_specs)
             if "mamba" in p]
    assert any("model" in s for _, s, _ in mamba)
    assert not any("model" in c for _, _, c in mamba)
    assert not TL._mamba_heads_split(cfg, mesh, rules)
    assert TL._mamba_heads_split(cfg, MeshShape({"data": 16, "model": 16}), rules)


# ---------------------------------------------------------------------------
# the mesh Trainer of the four reduced archs against the reference's mesh run
# ---------------------------------------------------------------------------
def assert_state_norms(got: list, want, paths: list) -> None:
    """Each state leaf's norm within 1e-4 relative, or within 1e-6 of the
    largest norm of its kind (the params, or one part of the optimizer
    state) where its gradient is a rounding-noise-sized remainder (zamba2's
    dt_bias moment, 1e-14 beside moments of 1e-4); as
    ``test_torch_train_loss`` holds a gradient leaf that is noise.  An
    attention key bias's state is not compared: its gradient is exactly 0
    and rounding noise, and AdamW moves each of its entries by about the
    learning rate whatever the noise's size, with the noise's sign."""
    def kind(p):
        return tuple(p.split("/")[:2 if p.startswith("opt_state/") else 1])

    top: dict = {}
    for p, w in zip(paths, want):
        top[kind(p)] = max(top.get(kind(p), 0.0), abs(float(w)))
    assert len(got) == len(want) == len(paths)
    for p, g, w in zip(paths, got, want):
        if "bk" not in p.split("/"):
            assert abs(g - w) <= max(F32_REL * abs(w), ZERO_GRAD_TOL * top[kind(p)]), (p, g, w)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_trainer_matches_the_reference_mesh_run(runs, arch):
    """Losses, each step's gradient norm and each state leaf's norm at the
    end (``assert_state_norms``; deepseek: Adafactor, its moments from the
    whole gradient)."""
    ref = runs["ref"]
    for r in runs["ranks"]:
        got = r[arch]
        assert len(got["losses"]) == STEPS
        np.testing.assert_allclose(got["losses"], ref[f"train/{arch}/losses"], rtol=F32_REL)
        np.testing.assert_allclose(got["grad_norms"], ref[f"train/{arch}/grad_norms"],
                                   rtol=F32_REL)
        assert_state_norms(got["state_norms"], ref[f"train/{arch}/state_norms"],
                           got["state_paths"])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_trainer_collectives_recorded_equal_the_analytic_count(runs, arch):
    for r in runs["ranks"]:
        assert len(r[arch]["recorded"]) == STEPS
        for rec in r[arch]["recorded"]:
            assert rec == r[arch]["analytic"]


# the leaves each arch's reduced config computes on its "model" block on 2 x 4, by kind
TP_LEAVES = {
    "deepseek-v3-671b": ("dense_blocks/attn/wq_b", "dense_blocks/mlp/wd", "blocks/attn/wo",
                         "blocks/moe/shared/wg", "mtp/block/attn/wk_b", "embed/tokens"),
    "mamba2-780m": ("blocks/mamba/wx", "blocks/mamba/A_log", "blocks/mamba/wo", "embed/tokens"),
    "zamba2-7b": ("blocks/mamba/wz", "shared/attn/wq", "shared/mlp/wd", "embed/unembed"),
    "whisper-tiny": ("enc_blocks/attn/wq", "enc_blocks/mlp/wi", "blocks/cross_attn/wk",
                     "blocks/self_attn/bv", "embed/tokens"),
}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_trainer_computes_on_the_model_blocks(runs, arch):
    """Every rank's step computes the family's leaves on their "model"
    block (``MeshLayout.compute_specs``), the expert leaves aside."""
    for r in runs["ranks"]:
        assert set(TP_LEAVES[arch]) <= set(r[arch]["tp_leaves"])
        assert not any(p.endswith(("/moe/wg", "/moe/wu", "/moe/wd")) for p in r[arch]["tp_leaves"])


# ---------------------------------------------------------------------------
# the layout's arithmetic at full width on 16 x 16 (no world)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch, whole_gb, split_gb", [
    ("deepseek-v3-671b", 40.93, 9.70), ("zamba2-7b", 13.58, 0.99), ("mamba2-780m", 1.56, 0.13),
    ("whisper-tiny", 0.07, 0.02)])
def test_compute_layout_bytes_a_rank_are_the_model_blocks(arch, whole_gb, split_gb):
    """The bytes a rank holds for the step under the TP rules with fsdp on
    16 x 16 (256 x 4096 tokens) are each leaf's "model" block summed; the
    same leaves gathered whole, as the step gathered them before the
    families had a tensor-parallel body, hold the first figure."""
    cfg = get_config(arch)
    mesh = MeshShape({"data": 16, "model": 16})
    lay = TL.MeshLayout(cfg, mesh, tensor_parallel_rules(fsdp=True), 256, 4096)

    def nbytes(d, spec):
        return math.prod(shard_shape(d.shape, spec, mesh)) * d.dtype.itemsize

    leaves = list(zip(lay.paths, lay.param_defs, lay.param_specs, lay.compute_specs))
    split = sum(nbytes(d, c) for _, d, _, c in leaves)
    blocks = sum(nbytes(d, c if TL._is_expert(p) else tuple(
        "model" if "model" in entry_axes(e) else None for e in s)) for p, d, s, c in leaves)
    whole = sum(nbytes(d, c if TL._is_expert(p) else (None,) * len(c)) for p, d, _, c in leaves)
    assert split == blocks
    assert (round(whole / 1e9, 2), round(split / 1e9, 2)) == (whole_gb, split_gb)


def test_step_and_forward_count_the_norm_and_the_shared_block_sums():
    """zamba2-7b on 16 x 16: ``tp_collectives`` lists the norm's sum of
    squares (f32, one a Mamba2 layer) and the shared block's attention and
    MLP sums once an application (14 of them over 81 layers, not once a
    layer); the dry run's forward sends them, and a step under remat sends
    each once more than without (its early stop spares the Mamba2 wo sum,
    the last thing its layer does)."""
    cfg = get_config("zamba2-7b")
    mesh = MeshShape({"data": 16, "model": 16})
    rules = tensor_parallel_rules(fsdp=True)
    lay = TL.MeshLayout(cfg, mesh, rules, 256, 4096)
    b, s = lay.local_batch, 4096
    row = b * s * cfg.d_model * cfg.dtype.itemsize
    tp = TL.tp_collectives(lay, b, s, cfg.dtype)
    apps = math.ceil(cfg.num_layers / cfg.attn_every)
    assert apps == 14
    assert ("norm", 4 * b * s, cfg.num_layers, True) in tp
    assert tp.count(("shared", row, apps, True)) == 2
    assert ("layer", row, cfg.num_layers, False) in tp  # the Mamba2 wo sum
    fwd = dryrun.forward_collectives(cfg, mesh, rules, 256, s)
    sums = sum(n * c for w, n, c, _ in tp if w in ("layer", "norm", "shared", "embed"))
    assert fwd.operand_bytes["all-reduce"] == sums
    full = TL.step_collectives(cfg, mesh, rules, 256, s)
    none = TL.step_collectives(dataclasses.replace(cfg, remat="none"), mesh, rules, 256, s)
    again = full.operand_bytes["all-reduce"] - none.operand_bytes["all-reduce"]
    assert again == cfg.num_layers * 4 * b * s + 2 * apps * row


def test_forward_counts_whisper_encoder_sums_in_a_prefill_not_a_decode():
    """whisper-tiny's encoder layers sum over its 1500 frames in a prefill;
    a decode step (one token a row over a cache of 448 positions) reads the
    cross K/V its prefill left: beside its flash-decoding collectives
    (``decode_collectives``), it sends a one-token prefill's sums but the
    encoder's."""
    cfg = get_config("whisper-tiny")
    mesh = MeshShape({"data": 16, "model": 16})
    rules = tensor_parallel_rules()
    lay = TL.MeshLayout(cfg, mesh, rules, 256, 1)
    enc = [t for t in TL.tp_collectives(lay, lay.local_batch, 1, cfg.dtype)
           if t[0] == "encoder"]
    assert enc and {t[2] for t in enc} == {cfg.encoder_layers}
    enc_bytes = sum(n * c for _, n, c, _ in enc)
    pre = dryrun.forward_collectives(cfg, mesh, rules, 256, 1)
    dec = dryrun.forward_collectives(cfg, mesh, rules, 256, 448, decode=True)
    flash = C.CollectiveStats()
    dryrun.decode_collectives(lay, 448, flash)
    assert flash.operand_bytes["all-reduce"] > 0
    sent = dec.operand_bytes["all-reduce"] - flash.operand_bytes["all-reduce"]
    assert pre.operand_bytes["all-reduce"] - sent == enc_bytes


def test_every_arch_splits_its_model_leaves_on_16x16():
    """Where the storage splits a non-expert leaf over "model", the step
    computes it on that block, for every family (whisper-tiny's 6 heads do
    not divide 16: its attention leaves are stored and computed whole)."""
    rules = tensor_parallel_rules(fsdp=True)
    mesh = MeshShape({"data": 16, "model": 16})
    cfg = get_config("whisper-tiny")
    heads = spec_for(W.flat_defs(W.TP_KINDS["enc_block"][0](cfg))["attn/wq"], mesh, rules)
    assert "model" not in heads
    lay = TL.MeshLayout(cfg, mesh, rules, 256, 448)
    split = {"/".join(map(str, p)) for p, c in zip(lay.paths, lay.compute_specs) if "model" in c}
    assert split == {"embed/tokens"} | {f"{s}/mlp/{k}" for s in ("blocks", "enc_blocks")
                                        for k in ("wi", "bi", "wo")}
