"""The port's train step and Trainer (``training/train_loop.py``) and the
training launcher (``launch/train.py --execute``) on the CPU: the
reference's ``tests/test_trainer_integration.py`` mirrored (the loss falls
and survives a failure; accumulation over 2 microbatches equals one batch),
one ``make_train_step`` step held to the reference's from the same f32
weights and batch, the restart's replay bit for bit (the CPU is
deterministic), a checkpoint restored into a fresh Trainer in place, and
the launcher.

A train step's first AdamW update is lr·g / (|g| + eps), lr·sign(g)
wherever |g| ≫ eps = 1e-8, so a gradient entry near eps or 0 (whose size
and sign the two frameworks' gradients, equal to 1e-4 of a leaf's largest
|g|, do not fix) moves its weight by up to 2·lr: a step is held to 1e-6 of
each leaf's largest magnitude plus the move that gradient tolerance allows
each entry (``step_close``).

AdamW's state after that step (m, v and the f32 master weights) is held,
for both packages, to the same step taken in float64 from the port's loss
in float64 (``adamw_f64``): the two f32 gradients differ from the float64
one by up to 1.7e-5 (port) and 2.1e-5 (reference) of a leaf's largest
|g| (granite-3-8b, reduced), f32 reduction noise within the gradients'
1e-4; held to each other instead, one master entry whose gradient is
-4.56e-9 (float64; port -4.18e-9, reference -2.76e-9, all near eps) sat
6.4e-5 apart, over 1e-4 of the leaf's largest weight."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.launch import train as launcher
from repro_torch.models.model import init_model, param_defs
from repro_torch.models.params import params_from_numpy, tree_flatten, tree_map
from repro_torch.training import train_loop
from repro_torch.training.optimizer import Schedule, init_opt_state
from repro_torch.training.train_loop import Trainer, TrainerConfig, _grads_of, make_train_step

from test_torch_moe import numpy_params
from test_torch_train_loss import GRAD_TOL, numpy_batch

torch.set_num_threads(1)
STEP_TOL = 1e-6
WEIGHT_DECAY = 0.1  # adamw_update's default in both packages


def tiny_cfg() -> ArchConfig:
    return ArchConfig(
        name="tiny-lm", family="dense", num_layers=2, d_model=96,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=256, remat="none",
    )


def test_loss_decreases_and_survives_failure(tmp_path):
    cfg = tiny_cfg()
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=48, global_batch=8, seed=0, branching=4)
    tc = TrainerConfig(num_steps=40, log_every=5, checkpoint_every=10,
                       checkpoint_dir=str(tmp_path / "ckpt"), peak_lr=3e-3, warmup_steps=5)
    tr = Trainer(cfg, ds, tc, device="cpu")
    tr._failure_at = 23  # between checkpoints → must restore step 20 + replay
    stats = tr.run()
    assert stats["restarts"] == 1
    losses = [m["loss"] for m in stats["metrics"]]
    assert losses[-1] < losses[0] - 0.3, losses
    assert np.isfinite(losses).all()


def test_grad_accumulation_matches_single_batch():
    """accum=2 over one batch == accum=1 (same grads, same update)."""
    cfg = tiny_cfg()
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=1)
    params = tree_map(lambda t: t.float(), init_model(cfg, torch.Generator().manual_seed(0),
                                                      "cpu"))
    batch = make_batch(cfg, ds, 0, device="cpu")
    sched = Schedule(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    out = []
    for accum in (1, 2):
        p = tree_map(lambda t: t.clone(), params)
        opt = init_opt_state(cfg.optimizer, param_defs(cfg), p)
        out.append(make_train_step(cfg, sched, accum=accum)(p, opt, batch, 3))
    (p1, _, m1), (p2, _, m2) = out
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]), rel=1e-5)
    for a, b in zip(tree_flatten(p1), tree_flatten(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3, rtol=5e-2)


def step_close(got: torch.Tensor, want, lr: float, grad=None):
    """A param after a step within STEP_TOL of the leaf's largest magnitude;
    with ``grad`` (AdamW's first step, lr·g / (|g| + eps)), plus what a
    gradient error d of 1e-4 of the leaf's largest |g| moves that step by:
    lr·d·eps / (|g| - d + eps)², at most 2·lr (a sign flip)."""
    want = np.asarray(want)
    err = np.abs(got.numpy() - want)
    tol = STEP_TOL * max(float(np.abs(want).max()), 1e-30)
    if grad is not None:
        d = GRAD_TOL * float(np.abs(grad).max())
        near = np.maximum(np.abs(grad) - d, 0) + jopt.ADAM_EPS
        tol = tol + lr * np.minimum(2.0, d * jopt.ADAM_EPS / near ** 2)
    assert (err <= tol).all(), err.max()


def adamw_f64(arch: str, params: dict, batch: dict, lr: float) -> dict:
    """The first AdamW step in float64 (torch on the CPU) from the port's
    loss in float64: the clipped gradient ``g`` and the state ``m``, ``v``,
    ``master``, numpy leaves in tree order.  At t = 1 the bias-corrected
    step is g / (|g| + eps), plus weight decay on matrices."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float64)
    p64 = tree_map(lambda t: t.double(), params_from_numpy(params, "cpu"))
    _, _, grads = _grads_of(p64, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    g = [t.numpy() for t in tree_flatten(grads)]
    norm = np.sqrt(sum(float((x * x).sum()) for x in g))
    g = [x * min(1.0, jopt.CLIP_NORM / max(norm, 1e-9)) for x in g]
    p = [t.numpy() for t in tree_flatten(p64)]
    step = [x / (np.abs(x) + jopt.ADAM_EPS) + (WEIGHT_DECAY * w if w.ndim >= 2 else 0.0)
            for x, w in zip(g, p)]
    return {"g": g, "m": [(1 - jopt.ADAM_B1) * x for x in g],
            "v": [(1 - jopt.ADAM_B2) * x * x for x in g],
            "master": [w - lr * s for w, s in zip(p, step)]}


@pytest.mark.parametrize("arch, accum", [("granite-3-8b", 1), ("granite-3-8b", 2),
                                         ("deepseek-v3-671b", 1)])
def test_train_step_matches_jax(arch, accum):
    """One step of ``make_train_step`` (granite: AdamW; deepseek: Adafactor
    with the MTP loss) from the same f32 weights and batch: the metrics,
    and every param and optimizer-state leaf (AdamW's, of both packages,
    against ``adamw_f64``)."""
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, numpy_params(jmodel.param_defs(jcfg), rng))
    batch = numpy_batch(jcfg, rng)
    jsched, tsched = jopt.Schedule(1e-3, 0, 10), Schedule(1e-3, 0, 10)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jcfg.optimizer, jmodel.param_defs(jcfg), jp, jax.random.PRNGKey(0))
    jp, js, jm = jax.jit(jloop.make_train_step(jcfg, jsched, accum=accum))(
        jp, js, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(3))
    tp = params_from_numpy(params, "cpu")
    ts = init_opt_state(tcfg.optimizer, param_defs(tcfg), tp)
    tp, ts, tm = make_train_step(tcfg, tsched, accum=accum)(
        tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    assert tm.keys() == jm.keys()
    for k in tm:
        assert abs(float(tm[k]) - float(jm[k])) <= 2e-5 * max(abs(float(jm[k])), 1e-3), k
    lr = float(tsched(3))
    # the reference's gradients: its first moment is (1 - b1)·g
    grads = [np.asarray(m) / (1 - jopt.ADAM_B1) for m in jax.tree.leaves(js["m"])] \
        if jcfg.optimizer == "adamw" else [None] * len(tree_flatten(tp))
    for g, w, grad in zip(tree_flatten(tp), jax.tree.leaves(jp), grads):
        step_close(g, w, lr, grad)
    for g, w in zip(tree_flatten(ts), jax.tree.leaves(js)):
        if g.dtype == torch.int32:
            assert int(g) == int(w) == 1
    if jcfg.optimizer != "adamw":
        return
    want = adamw_f64(arch, params, batch, lr)
    for name in ("m", "v", "master"):
        for pkg, leaves in (("port", [t.numpy() for t in tree_flatten(ts[name])]),
                            ("reference", [np.asarray(t) for t in jax.tree.leaves(js[name])])):
            assert len(leaves) == len(want[name])
            for got, ref, grad in zip(leaves, want[name], want["g"]):
                if name == "master":  # a step: near eps a gradient's noise moves it
                    step_close(torch.tensor(got), ref, lr, grad)
                else:  # moments: the gradients' tolerance
                    np.testing.assert_allclose(got, ref, rtol=0, err_msg=f"{pkg} {name}",
                                               atol=1e-4 * max(float(np.abs(ref).max()), 1e-30))


def small_trainer(tmp_path, name: str, steps: int = 8, **kw) -> Trainer:
    cfg = dataclasses.replace(get_reduced_config("granite-3-8b"), remat="none")
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=2)
    tc = TrainerConfig(num_steps=steps, log_every=1, checkpoint_every=3, keep=5,
                       checkpoint_dir=str(tmp_path / name), warmup_steps=2, **kw)
    return Trainer(cfg, ds, tc, device="cpu")


def state_bytes(tr: Trainer) -> list:
    return [t.clone() for t in tree_flatten(tr._state())]


def test_restart_replays_the_uninterrupted_run_bit_for_bit(tmp_path, monkeypatch):
    """A failure at step 5 restores step 3 and replays steps 4 and 5 from the
    same batches: the final state and every logged loss are the run
    without the failure's, bit for bit."""
    seen = []
    real = train_loop.make_batch
    monkeypatch.setattr(train_loop, "make_batch", lambda cfg, ds, step, **kw: (
        seen.append((step, real(cfg, ds, step, **kw))) or seen[-1][1]))
    clean = small_trainer(tmp_path, "clean")
    clean_stats = clean.run()
    seen.clear()
    failed = small_trainer(tmp_path, "failed")
    failed._failure_at = 5
    stats = failed.run()
    assert stats["restarts"] == 1 and clean_stats["restarts"] == 0
    steps = [s for s, _ in seen]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 7] or steps == [0, 1, 2, 3, 4, 4, 5, 6, 7], steps
    first = {}
    for step, batch in seen:
        if step in first:
            for k in batch:
                assert torch.equal(batch[k], first[step][k])
        first[step] = batch
    for a, b in zip(state_bytes(clean), state_bytes(failed)):
        assert torch.equal(a, b)
    last = {m["step"]: m["loss"] for m in stats["metrics"]}
    assert last == {m["step"]: m["loss"] for m in clean_stats["metrics"]}


def test_checkpoint_restores_into_a_fresh_trainer_in_place(tmp_path):
    """A fresh Trainer on the same directory restores the final checkpoint
    into its own tensors (their storage kept), equal to the first
    Trainer's state bit for bit."""
    first = small_trainer(tmp_path, "ckpt", steps=5)
    first.run()
    fresh = small_trainer(tmp_path, "ckpt", steps=5)
    before = [t.untyped_storage().data_ptr() for t in tree_flatten(fresh._state())]
    assert fresh._restore() == 5
    after = tree_flatten(fresh._state())
    assert [t.untyped_storage().data_ptr() for t in after] == before
    for a, b in zip(tree_flatten(first._state()), after):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(fresh.opt_state["step"]) == 5


def test_restore_without_a_checkpoint_starts_over(tmp_path):
    tr = small_trainer(tmp_path, "none")
    init = state_bytes(tr)
    tr.run()
    import shutil

    shutil.rmtree(tr.tc.checkpoint_dir)
    tr.ckpt = type(tr.ckpt)(tr.tc.checkpoint_dir)
    assert tr._restore() == 0
    for a, b in zip(init, state_bytes(tr)):
        assert torch.equal(a, b)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "granite-3-8b", "--reduced", "--execute", "--steps", "4", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training granite-3-8b-reduced on cpu: 4 steps of 2 x 16 tokens")
    assert out[-1].startswith("steps=4 restarts=0 loss ")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000003"]


def test_launcher_accumulates_with_adafactor(tmp_path, capsys):
    argv = ["--arch", "deepseek-v3-671b", "--reduced", "--execute", "--steps", "2", "--batch",
            "4", "--seq", "8", "--accum", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert "accum 2, optimizer adafactor" in out[0]


def test_launcher_plan_mode_names_the_item_it_waits_for(capsys):
    """The plan mode waited for the step cost model (Queue A item 14's
    single-device part), which is ported now: ``--arch`` without
    ``--execute`` prints the plan on the card's constants and exits 0
    (its lines against the reference's: ``tests/test_torch_step_model.py``)."""
    assert launcher.main(["--arch", "granite-3-8b"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 5
    assert out[0] == "arch=granite-3-8b shape=train_4k chips=256 (dp=16 tp=16 fsdp=False)"
    assert out[3].startswith("roofline: compute=") and "bottleneck=" in out[3]
