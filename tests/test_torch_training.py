"""The port's training substrate (``training/{optimizer,checkpoint,fault}.py``,
``data/pipeline.py``) on the CPU: the reference's ``tests/test_training.py``
mirrored test for test, then held against the JAX package with the same
numpy inputs — the schedule, one AdamW and one Adafactor step from the same
gradients, the synthetic data bit for bit, and checkpoints written by one
package and restored by the other.

Tolerances: an optimizer step to 1e-6 of each leaf's largest magnitude (f32
params: the sums of the means and norms run in another order); the
schedule bit for bit where it has no transcendental, within one f32 ulp
where it takes a cosine (XLA's CPU cos is one ulp off the correctly rounded
value at ~3% of the steps; torch's is not: the reference's behaviour,
pinned)."""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.data import pipeline as jdata
from repro.models import model as jmodel
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import SyntheticLM, make_batch, unigram_entropy_bits
from repro_torch.models.model import param_defs
from repro_torch.models.params import (
    ParamDef, count_params, params_from_numpy, tree_flatten, tree_map,
)
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault import (
    RestartPolicy, StragglerDetector, WorkerFailure, run_with_restarts,
)
from repro_torch.training.optimizer import (
    Schedule,
    adafactor_state_defs,
    adamw_state_defs,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    opt_update,
)

torch.set_num_threads(1)
STEP_TOL = 1e-6


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.ones((2, 4)) * 2.0}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    params = _quadratic_params()
    defs = tree_map(lambda t: ParamDef(tuple(t.shape), (None,) * t.dim(), dtype=t.dtype), params)
    state = init_opt_state(name, defs, params)

    def loss(p):
        return sum(torch.sum(x * x) for x in tree_flatten(p))

    l0 = float(loss(params))
    for _ in range(60):
        g = tree_map(lambda x: 2 * x, params)  # d/dx of x·x
        params, state = opt_update(name, params, g, state, torch.tensor(0.05))
    assert float(loss(params)) < 0.2 * l0
    assert int(state["step"]) == 60


def test_adafactor_state_is_factored():
    defs = param_defs(get_reduced_config("granite-3-8b"))
    full = adamw_state_defs(defs)
    fact = adafactor_state_defs(defs)
    assert count_params(fact["vr"]) + count_params(fact["vc"]) < 0.2 * count_params(full["m"])


def test_schedule_warmup_and_decay():
    s = Schedule(peak_lr=1e-3, warmup_steps=10, total_steps=100, min_ratio=0.1)
    assert float(s(0)) == 0.0
    assert float(s(10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(s(5)) == pytest.approx(5e-4, rel=1e-5)
    assert float(s(100)) == pytest.approx(1e-4, rel=1e-3)
    lrs = [float(s(t)) for t in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(lrs, lrs[1:]))


def test_clip_by_global_norm():
    tree = {"a": torch.ones(10) * 10.0, "b": torch.ones(5) * -10.0}
    clipped, norm = clip_by_global_norm(tree, max_norm=1.0)
    assert float(norm) == pytest.approx(float(global_norm(tree)))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = clip_by_global_norm({"a": torch.tensor([0.1])}, max_norm=1.0)
    np.testing.assert_allclose(same["a"].numpy(), [0.1], rtol=1e-6)


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_with_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {
        "w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
        "opt": {"m": torch.ones((2, 2)), "step": torch.tensor(7, dtype=torch.int32)},
    }
    mgr.save(5, tree, metadata={"loss": 1.25}, blocking=True)
    step, restored, meta = mgr.restore(like=tree, device="cpu")
    assert step == 5 and meta["loss"] == 1.25
    for a, b in zip(tree_flatten(tree), tree_flatten(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_000003", "step_000004"]


def test_torn_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.zeros(3)}
    mgr.save(1, tree, blocking=True)
    torn = tmp_path / "step_000002"  # a torn (uncommitted) later checkpoint
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=2, like=tree, device="cpu")


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.arange(5, dtype=torch.float32)}
    mgr.save(3, tree, blocking=False)
    mgr.wait()
    step, restored, _ = mgr.restore(like=tree, device="cpu")
    assert step == 3
    np.testing.assert_array_equal(restored["x"].numpy(), np.arange(5, dtype=np.float32))


# ---------------------------------------------------------------------------
# Fault tolerance
# ---------------------------------------------------------------------------
def test_straggler_detector_flags_persistent_slowdown():
    det = StragglerDetector(warmup=5, patience=3, z_threshold=3.0)
    fired = []
    for i, t in enumerate([0.10] * 20 + [0.50] * 6 + [0.10] * 5):
        if det.observe(t):
            fired.append(i)
            det.reset()
    assert fired and 22 <= fired[0] <= 25  # third consecutive slow step


def test_straggler_detector_tolerates_jitter():
    rng = np.random.default_rng(0)
    det = StragglerDetector(warmup=5, patience=3)
    for t in 0.1 + 0.01 * rng.standard_normal(200):
        assert not det.observe(max(t, 0.05))


def test_run_with_restarts_replays_from_checkpoint():
    executed = []
    state = {"restored_to": None}

    def step_fn(step):
        executed.append(step)
        if step == 5 and state["restored_to"] is None:
            raise WorkerFailure("boom")

    def restore_fn():
        state["restored_to"] = 3
        return 3

    stats = run_with_restarts(step_fn, start_step=0, num_steps=8, restore_fn=restore_fn,
                              policy=RestartPolicy(max_restarts=2), sleep=lambda s: None)
    assert stats["restarts"] == 1
    assert executed == [0, 1, 2, 3, 4, 5, 3, 4, 5, 6, 7]  # deterministic replay


def test_run_with_restarts_gives_up():
    def step_fn(step):
        raise WorkerFailure("always")

    with pytest.raises(WorkerFailure):
        run_with_restarts(step_fn, start_step=0, num_steps=3, restore_fn=lambda: 0,
                          policy=RestartPolicy(max_restarts=2), sleep=lambda s: None)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------
def test_data_deterministic_and_distinct():
    ds = SyntheticLM(vocab_size=128, seq_len=32, global_batch=8, seed=1, num_hosts=2)
    a, b = ds.batch(step=3, host=0), ds.batch(step=3, host=0)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], ds.batch(step=4, host=0)["tokens"])
    assert not np.array_equal(a["tokens"], ds.batch(step=3, host=1)["tokens"])


def test_labels_are_next_tokens_from_chain():
    ds = SyntheticLM(vocab_size=64, seq_len=16, global_batch=4, seed=0, branching=4)
    batch = ds.batch(0)
    toks, labels = batch["tokens"], batch["labels"]
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])  # shifted view
    chain = ds._chain()
    for b in range(toks.shape[0]):
        for t in range(toks.shape[1]):
            assert labels[b, t] in chain[toks[b, t]]
    assert unigram_entropy_bits(ds) == 2.0


def test_vlm_batch_masks_frontend_positions():
    cfg = get_reduced_config("internvl2-76b")
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    batch = make_batch(cfg, ds, step=0, device="cpu")
    assert batch["frontend_embeds"].shape == (2, cfg.frontend_seq, cfg.d_model)
    labels = batch["labels"].numpy()
    assert (labels[:, :cfg.frontend_seq] == -1).all()
    assert (labels[:, cfg.frontend_seq:] >= 0).all()


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed, steps, host, hosts, arch", [
    (0, (0, 1, 7), 0, 1, "granite-3-8b"), (3, (2, 40), 1, 2, "internvl2-76b"),
    (5, (0, 9), 0, 1, "whisper-tiny")])
def test_synthetic_data_is_the_references_bit_for_bit(seed, steps, host, hosts, arch):
    """Tokens and labels of ``make_batch``; the vlm's label mask and the
    front-end stubs' shapes and types (their numbers come from another
    generator)."""
    jcfg, tcfg = jax_config(arch), get_reduced_config(arch)
    kw = dict(vocab_size=tcfg.vocab_size, seq_len=24, global_batch=4, seed=seed, num_hosts=hosts)
    jds, tds = jdata.SyntheticLM(**kw), SyntheticLM(**kw)
    np.testing.assert_array_equal(jds._chain(), tds._chain())
    for step in steps:
        want = jdata.make_batch(jcfg, jds, step, host)
        got = make_batch(tcfg, tds, step, host, device="cpu")
        assert got.keys() == want.keys()
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        if "frontend_embeds" in got:
            assert tuple(got["frontend_embeds"].shape) == want["frontend_embeds"].shape
            assert got["frontend_embeds"].dtype == tcfg.dtype
            again = make_batch(tcfg, tds, step, host, device="cpu")["frontend_embeds"]
            assert torch.equal(got["frontend_embeds"], again)


def test_schedule_matches_jax():
    """Bit for bit through warmup, and over the cosine wherever the two
    cosines agree; where XLA's is one ulp off, that ulp is the only
    difference."""
    for kw in (dict(), dict(peak_lr=1e-3, warmup_steps=10, total_steps=100),
               dict(peak_lr=3e-3, warmup_steps=20, total_steps=300, min_ratio=0.05)):
        js, ts = jopt.Schedule(**kw), Schedule(**kw)
        steps = np.arange(0, js.total_steps + 3, dtype=np.int32)
        want = np.asarray(js(jnp.asarray(steps)))
        got = ts(torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        t = np.clip((steps.astype(np.float32) - js.warmup_steps)
                    / np.float32(max(js.total_steps - js.warmup_steps, 1)), 0, 1)
        jcos = np.asarray(jnp.cos(jnp.pi * jnp.asarray(t)))
        tcos = torch.cos(np.pi * torch.from_numpy(t)).numpy()
        ulps = np.abs(jcos.view(np.int32).astype(np.int64) - tcos.view(np.int32))
        assert ulps.max() <= 1
        same = (ulps == 0) | (steps < js.warmup_steps)
        np.testing.assert_array_equal(got[same], want[same])
        np.testing.assert_allclose(got, want, rtol=1e-5)


def f32_tree(defs, rng, scale):
    return jax.tree.map(lambda d: (rng.standard_normal(d.shape) * scale).astype(np.float32), defs,
                        is_leaf=lambda d: hasattr(d, "init"))


def leaves_close(got: list, want: list, tol=STEP_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30))


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b"])
def test_optimizer_steps_match_jax(arch):
    """Three steps of the arch's optimizer (granite AdamW with f32 masters,
    deepseek Adafactor) from the same f32 params and numpy gradients: every
    param and state leaf, stacked norm scales (L, D) decayed and factored as
    the reference does."""
    jcfg, tcfg = jax_config(arch), get_reduced_config(arch)
    rng = np.random.default_rng(1)
    defs = jmodel.param_defs(jcfg)
    params = f32_tree(defs, rng, 0.1)
    grads = [f32_tree(defs, rng, 0.01) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jcfg.optimizer, defs, jp, jax.random.PRNGKey(0))
    tp = params_from_numpy(params, "cpu")
    ts = init_opt_state(tcfg.optimizer, param_defs(tcfg), tp)
    jsched, tsched = jopt.Schedule(1e-3, 2, 10), Schedule(1e-3, 2, 10)
    jupdate = jax.jit(jopt.opt_update, static_argnums=0)  # one compile, not one a leaf op
    for step, g in enumerate(grads):
        jp, js = jupdate(jcfg.optimizer, jp, jax.tree.map(jnp.asarray, g), js, jsched(step))
        opt_update(tcfg.optimizer, tp, params_from_numpy(g, "cpu"), ts, tsched(step))
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
    leaves_close(tree_flatten(tp), jax.tree.leaves(jp))
    leaves_close(tree_flatten(ts), jax.tree.leaves(js))


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    tree = {"a": (rng.standard_normal((3, 40)) * 3).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree))
    tc, tn = clip_by_global_norm(params_from_numpy(tree, "cpu"))
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    leaves_close(tree_flatten(tc), jax.tree.leaves(jc))


def test_adamw_masters_are_copies_of_f32_params():
    """``.to(float32)`` of an f32 param is the param itself: the masters
    would alias the params, and the in-place update would write each param
    twice.  They are copies, and a step moves the params by exactly the
    masters' update."""
    params = {"w": torch.ones((3, 4)), "s": torch.ones(4)}
    defs = tree_map(lambda t: ParamDef(tuple(t.shape), (None,) * t.dim(), dtype=t.dtype), params)
    state = init_opt_state("adamw", defs, params)
    for p, m in zip(tree_flatten(params), tree_flatten(state["master"])):
        assert p.untyped_storage().data_ptr() != m.untyped_storage().data_ptr()
    grads = {"w": torch.full((3, 4), 0.5), "s": torch.full((4,), -0.5)}
    opt_update("adamw", params, grads, state, torch.tensor(0.1))
    # first step: m/bc1 = g, sqrt(v/bc2) = |g|: step = sign(g) (+ decay 0.1 for ndim >= 2)
    np.testing.assert_allclose(params["w"].numpy(), 1 - 0.1 * (1 + 0.1), rtol=1e-6)
    np.testing.assert_allclose(params["s"].numpy(), 1 + 0.1, rtol=1e-6)
    assert torch.equal(params["w"], state["master"]["w"])


def test_async_save_snapshots_before_the_next_update(tmp_path, monkeypatch):
    """A save in flight writes the state as it was at ``save``, though the
    caller's next in-place update runs before the thread writes (a CPU
    tensor's ``.cpu()`` is itself: the snapshot must be a copy)."""
    go = threading.Event()
    write = CheckpointManager._write

    def held_write(self, *args):
        assert go.wait(timeout=30)
        write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.arange(6, dtype=torch.float32), "b": torch.ones(2, dtype=torch.bfloat16)}
    mgr.save(1, tree)
    tree["x"].add_(100.0)  # the next step, in place
    tree["b"].mul_(3)
    go.set()
    mgr.wait()
    _, restored, _ = mgr.restore(like=tree, device="cpu")
    np.testing.assert_array_equal(restored["x"].numpy(), np.arange(6, dtype=np.float32))
    assert torch.equal(restored["b"], torch.ones(2, dtype=torch.bfloat16))


def checkpoint_tree(rng):
    """A training state's shapes of leaves: bf16 params, f32 moments, an
    int32 step, keys out of sorted order."""
    return {"params": {"w": (rng.standard_normal((3, 5)) * 4).astype(jnp.bfloat16),
                       "a": rng.standard_normal(4).astype(np.float32)},
            "opt_state": {"step": np.asarray(9, np.int32),
                          "m": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                                "a": rng.standard_normal(4).astype(np.float32)}}}


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    tree = checkpoint_tree(np.random.default_rng(4))
    jckpt.CheckpointManager(str(tmp_path)).save(12, jax.tree.map(jnp.asarray, tree),
                                                metadata={"loss": 2.5}, blocking=True)
    like = params_from_numpy(tree, "cpu")
    step, got, meta = CheckpointManager(str(tmp_path)).restore(like=like, device="cpu")
    assert step == 12 and meta == {"loss": 2.5}
    for g, w in zip(tree_flatten(got), tree_flatten(like)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got["params"]["w"].dtype == torch.bfloat16


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    tree = checkpoint_tree(np.random.default_rng(5))
    CheckpointManager(str(tmp_path)).save(7, params_from_numpy(tree, "cpu"),
                                          metadata={"final": True}, blocking=True)
    like = jax.tree.map(jnp.asarray, tree)
    step, got, meta = jckpt.CheckpointManager(str(tmp_path)).restore(like=like)
    assert step == 7 and meta == {"final": True}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))
    manifest = json.loads((tmp_path / "step_000007" / "manifest.json").read_text())
    ref = tmp_path / "ref"
    jckpt.CheckpointManager(str(ref)).save(7, like, metadata={"final": True}, blocking=True)
    want = json.loads((ref / "step_000007" / "manifest.json").read_text())
    assert manifest == want


@pytest.mark.parametrize("fail_in", [None, "gather", "write"])
def test_written_behind_commits_only_a_whole_save(tmp_path, fail_in):
    """A mesh save writes each leaf on a thread while the next is gathered
    (``checkpoint._written_behind``): every leaf and the commit when both
    sides finish; no COMMITTED marker when the gather fails, and the
    writer's error raised on the caller's thread when the write fails."""
    from repro_torch.training import checkpoint as ckpt

    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(6.0), "b": torch.ones((2, 3), dtype=torch.bfloat16),
            "c": torch.zeros(4)}

    def leaves():
        for i, t in enumerate(tree_flatten(tree)):
            if fail_in == "gather" and i == 1:
                raise ConnectionError("a rank left")
            yield t.clone()

    def failing(ts):
        for i, t in enumerate(ts):
            if i == 1:
                raise OSError("disk full")
            yield t

    def write(ts):
        mgr._write(3, failing(ts) if fail_in == "write" else ts, "{}", {})

    if fail_in is None:
        ckpt._written_behind(write, leaves())
        step, got, _ = mgr.restore(like=tree, device="cpu")
        assert step == 3 and all(torch.equal(got[k], tree[k]) for k in tree)
        return
    with pytest.raises(ConnectionError if fail_in == "gather" else OSError):
        ckpt._written_behind(write, leaves())
    assert mgr.latest_step() is None
