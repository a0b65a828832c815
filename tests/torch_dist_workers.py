"""The port's side of ``tests/test_torch_distributed.py``: the body every
rank of a spawned gloo world runs (``repro_torch.launch.world.run_world``),
and the single process that builds the production meshes under torch's fake
process group.  No JAX here: each rank imports torch and the port only."""
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_reduced_config
from repro_torch.core import collectives as C
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import (
    embed_apply,
    embed_defs,
    gqa_apply,
    gqa_cross_apply,
    gqa_defs,
    mla_apply,
    mla_defs,
    mlp_apply,
    mlp_defs,
)
from repro_torch.models.model import init_model, lm_loss, param_defs
from repro_torch.models.params import params_from_numpy, tree_flatten, tree_unflatten
from repro_torch.models.quant import QuantTensor, quantize_weight
from repro_torch.sharding import layout
from repro_torch.sharding.rules import (
    activate_mesh,
    axis_sizes,
    batch_spec,
    entry_axes,
    spec_for,
    tensor_parallel_rules,
)
from repro_torch.training import train_loop as TL
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.grad_compress import dp_value_and_grad
from repro_torch.training.optimizer import init_opt_state

MOE_CASES = ("a2a", "a2a_split", "gather")
# the reference's subprocess: 8 forced host devices, whose in-process collectives wait for every
# device's thread; on a loaded host (the other test files' processes) one can take longer than
# XLA's default 40 s to arrive
REFERENCE_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                       "--xla_cpu_collective_call_terminate_timeout_seconds=600")
TRAIN_ARCHS = ("granite-3-8b", "granite-moe-3b-a800m")


def f32_config(arch: str):
    return dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)


def numpy_trainer(leaves: list):
    """A Trainer whose params start from the given f32 leaves (``param_defs``
    order), on every rank (each keeping its blocks on a mesh)."""

    class NumpyTrainer(TL.Trainer):
        def _init_params(self, keep):
            defs = param_defs(self.cfg)
            paths = TL._paths(defs)
            return tree_unflatten(defs, [
                t if keep is None else keep(path, t) for path, t in
                zip(paths, (torch.from_numpy(a.copy()).to(self.device) for a in leaves))])

    return NumpyTrainer


def train_setup(data: dict, arch: str):
    cfg = f32_config(arch)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=int(data["train/seq"]),
                     global_batch=int(data["train/batch"]))
    n = len(tree_flatten(param_defs(cfg)))
    return cfg, ds, [data[f"train/{arch}/{i}"] for i in range(n)]


def state_norms(tr) -> list:
    """The L2 norm of each leaf of the Trainer's (params, opt_state), in
    ``tree_flatten`` order, from the whole leaf (on a mesh every rank
    gathers it): the optimizer's moments scale with the gradient, which the
    losses alone do not show (AdamW and Adafactor divide it out)."""
    leaves = tree_flatten(tr._state())
    if tr.layout is not None:
        specs = tr.layout.opt_specs + tr.layout.param_specs  # the state's leaf order
        leaves = [layout.full(t.to_local(), tr.mesh, sp) for t, sp in zip(leaves, specs)]
    return [float(np.linalg.norm(t.detach().double().numpy())) for t in leaves]


def recorded_steps(tr) -> list:
    """The collectives of each of the Trainer's steps from now on (the step
    function's alone), in a list that fills as it steps."""
    recs, step_fn = [], tr.step_fn

    def recorded(*a):
        with C.recording() as rec:
            out = step_fn(*a)
        recs.append(rec.summary())
        return out

    tr.step_fn = recorded
    return recs


def _moe(data, mesh):
    cfg = get_reduced_config("granite-moe-3b-a800m")
    params = params_from_numpy({k: data[f"moe/{k}"] for k in ("router", "wg", "wu", "wd")}, "cpu")
    out = {}
    for case in MOE_CASES:
        x = torch.from_numpy(data[f"moe/x_{case}"])
        xs = layout.block_of(x, mesh, batch_spec(x.shape[0], mesh))
        ep_axes, mode, tp_split = moe.sharded_plan(cfg, mesh, xs.shape[0], xs.shape[1])
        local = dict(params)
        for k in ("wg", "wu", "wd"):
            local[k] = layout.block_of(params[k], mesh, moe._e_spec(ep_axes))
        with activate_mesh(mesh), C.recording() as rec:
            y, aux = moe.moe_apply(local, xs, cfg)
        want = moe.moe_collectives(cfg, mesh, xs.shape[0], xs.shape[1], x.dtype)
        y = layout.full(y, mesh, batch_spec(x.shape[0], mesh) + (None,))
        out[case] = {"mode": mode, "tp_split": tp_split, "y": y.numpy(), "aux": float(aux),
                     "recorded": rec.summary(), "analytic": want.summary()}
    # int8 experts (QuantTensor leaves, each rank's block of q and scale), both modes
    qparams = dict(params)
    for k in ("wg", "wu", "wd"):
        qparams[k] = quantize_weight(params[k], lead=1, n_contract=1)
    for case in ("a2a", "gather"):
        x = torch.from_numpy(data[f"moe/x_{case}"])
        xs = layout.block_of(x, mesh, batch_spec(x.shape[0], mesh))
        ep_axes = moe.sharded_plan(cfg, mesh, xs.shape[0], xs.shape[1])[0]
        local = dict(qparams)
        for k in ("wg", "wu", "wd"):
            local[k] = QuantTensor(*(layout.block_of(t, mesh, moe._e_spec(ep_axes))
                                     for t in qparams[k]))
        with activate_mesh(mesh):
            y, _ = moe.moe_apply(local, xs, cfg)
        out[f"int8_{case}"] = layout.full(y, mesh, batch_spec(x.shape[0], mesh) + (None,)).numpy()
    return out


def case_config(data, case: str):
    """A "tp/" case's config: its arch's reduced config (granite-3-8b where
    the case names none) in f32 with the case's overrides, the Mamba2
    ones under "ssm"."""
    arch = str(data.get(f"tp/{case}/arch", "granite-3-8b"))
    over = json.loads(str(data[f"tp/{case}/overrides"]))
    ssm = over.pop("ssm", None)
    cfg = dataclasses.replace(f32_config(arch), **over)
    return cfg if ssm is None else dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))


def nest(flat: dict) -> dict:
    """{"a/b": leaf} → {"a": {"b": leaf}}."""
    out: dict = {}
    for k, v in flat.items():
        *heads, last = k.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def flat_defs(tree, prefix: str = "") -> dict:
    """A ParamDef tree as {"a/b": ParamDef}."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat_defs(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


# each "tp/" kind: its ParamDefs, and the block as fn(params, x, extra input, labels, cfg)
TP_KINDS = {
    "gqa": (gqa_defs, lambda p, x, e, lb, cfg: gqa_apply(p, x, cfg)),
    "mlp": (mlp_defs, lambda p, x, e, lb, cfg: mlp_apply(p, x, cfg)),
    "embed": (embed_defs, lambda p, x, e, lb, cfg: embed_apply(p, x, cfg)),
    "loss": (embed_defs, lambda p, x, e, lb, cfg: lm_loss({"embed": p}, x, lb, cfg)),
    "mla": (mla_defs, lambda p, x, e, lb, cfg: mla_apply(p, x, cfg)),
    "shared_experts": (lambda cfg: moe.moe_defs(cfg)["shared"],
                       lambda p, x, e, lb, cfg: moe._shared_ffn(p, x, cfg)),
    "mamba": (ssm.mamba_defs, lambda p, x, e, lb, cfg: ssm.mamba_apply(p, x, cfg)),
    "shared_attn": (T.shared_attn_defs, lambda p, x, e, lb, cfg: T.shared_attn_apply(p, x, e, cfg)),
    "enc_block": (T.enc_block_defs, lambda p, x, e, lb, cfg: T.enc_block_apply(p, x, cfg)[0]),
    "dec_block": (T.dec_block_defs, lambda p, x, e, lb, cfg: T.dec_block_apply(p, x, e, cfg)[0]),
    "cross_attn": (lambda cfg: gqa_defs(cfg, cross=True),
                   lambda p, x, e, lb, cfg: gqa_cross_apply(p, x, T._cross_kv(p, e, cfg), cfg)),
}


def _tp_blocks(data, mesh) -> dict:
    """Each "tp/" case's block on the rank's "model" shards (the compute
    layout of the step under the TP rules), every rank on the whole batch:
    its output, and the gradients of its inputs (x, and the extra input e
    where the block takes one: hybrid's x0, whisper's encoder output) and
    of its leaves' blocks reduced as the step reduces them (the sum over the
    ranks that share a block, over the mesh size: every rank's backward
    starts from its own loss, here all the same).  A leaf is named by its
    key path, "/" between keys."""
    rules = tensor_parallel_rules()
    sizes = axis_sizes(mesh)

    def reduced(g, spec):
        used = {a for e in spec for a in entry_axes(e)}
        summed = C.all_reduce(g, mesh, tuple(a for a in sizes if a not in used))
        return (summed / mesh.size()).numpy()

    out = {}
    for case in json.loads(str(data["tp/cases"])):
        kind = str(data[f"tp/{case}/kind"])
        cfg = case_config(data, case)
        defs_of, fn = TP_KINDS[kind]
        defs = flat_defs(defs_of(cfg))
        prefix = f"tp/{case}/p/"
        whole = {k[len(prefix):]: torch.from_numpy(v) for k, v in data.items()
                 if k.startswith(prefix)}
        # the leaf's path as the step sees it: a Mamba2 block's under "mamba"
        path = lambda k: (("mamba",) if kind == "mamba" else ()) + tuple(k.split("/"))  # noqa: E731
        specs = {k: TL._compute_spec(cfg, path(k), defs[k], spec_for(defs[k], mesh, rules), mesh,
                                     rules, 1, 1) for k in whole}
        local = {k: layout.block_of(w, mesh, specs[k]).clone().requires_grad_()
                 for k, w in whole.items()}
        x = torch.from_numpy(data[f"tp/{case}/x"])
        x = x if kind == "embed" else x.requires_grad_()
        e = data.get(f"tp/{case}/e")
        e = None if e is None else torch.from_numpy(e).requires_grad_()
        labels = data.get(f"tp/{case}/labels")
        labels = None if labels is None else torch.from_numpy(labels)
        with torch.enable_grad(), activate_mesh(mesh, rules):
            y = fn(nest(local), x, e, labels, cfg)
            inputs = {"dx": x} if x.requires_grad else {}
            if e is not None:
                inputs["de"] = e
            wrt = list(local.values()) + list(inputs.values())
            grads = torch.autograd.grad(y, wrt, torch.from_numpy(data[f"tp/{case}/cot"]))
        with torch.no_grad():
            out[case] = {"y": y.detach().numpy(), "specs": {k: list(s) for k, s in specs.items()},
                         "grads": {k: reduced(g, specs[k]) for k, g in zip(local, grads)}}
            for name, g in zip(inputs, grads[len(local):]):
                out[case][name] = reduced(g, (None,) * g.dim())
    return out


def _first_draws(mesh) -> dict:
    """For each train arch, under the TP rules with fsdp: whether the mesh
    Trainer's leaf-by-leaf initial state (params and optimizer state, both
    optimizers) is, leaf by leaf and bit for bit, this rank's block of the
    whole draw's."""
    rules = tensor_parallel_rules(fsdp=True)
    out = {}
    for arch in TRAIN_ARCHS:
        for opt in ("adamw", "adafactor"):
            cfg = dataclasses.replace(get_reduced_config(arch), optimizer=opt)
            ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
            tc = TL.TrainerConfig(seed=3)
            with activate_mesh(mesh, rules):
                tr = TL.Trainer(cfg, ds, tc, mesh=mesh)
            params = init_model(cfg, torch.Generator().manual_seed(tc.seed), "cpu")
            state = init_opt_state(opt, param_defs(cfg), params)
            lay = tr.layout
            want = [layout.block_of(t, mesh, s) for t, s in
                    zip(tree_flatten(params) + tree_flatten(state),
                        lay.param_specs + lay.opt_specs)]
            got = [t.to_local() for t in tree_flatten(tr.params) + tree_flatten(tr.opt_state)]
            out[f"{arch}/{opt}"] = {
                "equal": [bool(torch.equal(a, b)) and a.dtype == b.dtype
                          for a, b in zip(got, want)],
                "split": sum(a.numel() < b.numel() for a, b in
                             zip(got, tree_flatten(params) + tree_flatten(state)))}
    return out


def _dp(data, mesh):
    params = {"w": torch.from_numpy(data["dp/w"])}
    xs = {k: layout.block_of(torch.from_numpy(data[f"dp/{k}"]), mesh, batch_spec(64, mesh))
          for k in ("x", "y")}

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    out = {}
    for name, compressed in (("exact", False), ("compressed", True)):
        l, g = dp_value_and_grad(loss, mesh, compressed=compressed)(params, xs)
        out[name] = {"loss": float(l), "g": g["w"].numpy()}
    # the per-rank gradients and scales the compressed mean was built from
    l_local = loss({"w": params["w"].requires_grad_()}, xs)
    g_local = torch.autograd.grad(l_local, params["w"])[0].detach()
    out["scale"] = float(g_local.abs().max() / 127.0)
    return out


def _elastic(rank, mesh, root):
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones((8,), dtype=torch.bfloat16)}
    mgr = CheckpointManager(os.path.join(root, "elastic"))
    if rank == 0:
        mgr.save(1, tree, blocking=True)  # saved unsharded ("old mesh")
    dist.barrier()
    from torch.distributed.tensor import Shard, Replicate

    # tree-flatten order is alphabetical: 'b', then 'w'
    shardings = [(mesh, [Replicate(), Shard(0)]), (mesh, [Shard(0), Shard(1)])]
    step, restored, _ = mgr.restore(like=tree, sharding_fn=lambda i, a: shardings[i])
    w, b = restored["w"], restored["b"]
    return {"step": step, "w_placements": [str(p) for p in w.placements],
            "w_local": w.to_local().numpy(), "b_local": b.to_local().float().numpy(),
            "w_full": layout.full(w.to_local(), mesh, ("data", "model")).numpy(),
            "is_dtensor": isinstance(w, DTensor) and isinstance(b, DTensor)}


def _trainer(rank, data, arch, mesh24, mesh42, root):
    cfg, ds, leaves = train_setup(data, arch)
    steps = int(data["train/steps"])
    tc = TL.TrainerConfig(num_steps=steps, log_every=1, checkpoint_every=2,
                          checkpoint_dir=os.path.join(root, arch))
    tr = numpy_trainer(leaves)(cfg, ds, tc, mesh=mesh24)
    tr._failure_at = steps - 1  # a restart from step 2's checkpoint, replaying the last step
    observe = tr.detector.observe
    tr.detector.observe = lambda dt: (rank == 0 and len(tr.metrics_log) == 1) or observe(dt)
    stats = tr.run()
    out = {"losses": [m["loss"] for m in stats["metrics"]], "restarts": stats["restarts"],
           "grad_norms": [m["grad_norm"] for m in stats["metrics"]],
           "checkpoints": sorted(os.listdir(tc.checkpoint_dir)), "state_norms": state_norms(tr)}
    with C.recording() as rec:
        _, _, metrics = tr.step_fn(tr.params, tr.opt_state, tr.batch(steps), steps)
    out["next_loss"] = float(metrics["loss"])
    out["next_grad_norm"] = float(metrics["grad_norm"])
    out["recorded"] = rec.summary()
    out["analytic"] = TL.step_collectives(cfg, mesh24, tensor_parallel_rules(), ds.global_batch,
                                          ds.seq_len, dtype=torch.float32).summary()
    if arch == TRAIN_ARCHS[0]:  # the final checkpoint, restored onto a 4 x 2 mesh
        tc2 = dataclasses.replace(tc, num_steps=steps + 1)
        tr2 = numpy_trainer(leaves)(cfg, ds, tc2, mesh=mesh42)
        start = tr2._restore()
        _, _, metrics = tr2.step_fn(tr2.params, tr2.opt_state, tr2.batch(start), start)
        out["restored_42"] = {"start": start, "loss": float(metrics["loss"]),
                              "grad_norm": float(metrics["grad_norm"])}
        # the Trainer with the int8 gradient all-reduce: every step, the first recorded
        tc3 = dataclasses.replace(tc, grad_compress=True, checkpoint_every=1000,
                                  checkpoint_dir=os.path.join(root, "compressed"))
        tr3 = numpy_trainer(leaves)(cfg, ds, tc3, mesh=mesh24)
        recs = recorded_steps(tr3)
        for step in range(steps):
            tr3._do_step(step)
        out["compressed"] = {
            "losses": [m["loss"] for m in tr3.metrics_log],
            "grad_norms": [m["grad_norm"] for m in tr3.metrics_log],
            "lrs": [m["lr"] for m in tr3.metrics_log], "recorded": recs[0],
            "analytic": TL.step_collectives(cfg, mesh24, tensor_parallel_rules(),
                                            ds.global_batch, ds.seq_len, compressed=True,
                                            dtype=torch.float32).summary()}
        out["adafactor"] = adafactor_steps(cfg, ds, leaves, mesh24, os.path.join(root, "af"))
    return out


def adafactor_steps(cfg, ds, leaves, mesh, directory: str) -> dict:
    """Two Adafactor steps (its factored moments from the whole gradient,
    each rank keeping its shard), the second recorded; on one device when
    ``mesh`` is None."""
    cfg = dataclasses.replace(cfg, optimizer="adafactor")
    tc = TL.TrainerConfig(num_steps=2, log_every=1, checkpoint_every=1000,
                          checkpoint_dir=directory)
    tr = numpy_trainer(leaves)(cfg, ds, tc, device="cpu" if mesh is None else None, mesh=mesh)
    recs = recorded_steps(tr)
    for step in range(2):
        tr._do_step(step)
    rows = tr.metrics_log
    out = {"losses": [m["loss"] for m in rows], "grad_norms": [m["grad_norm"] for m in rows],
           "state_norms": state_norms(tr), "recorded": recs[1]}
    if mesh is not None:
        out["analytic"] = TL.step_collectives(cfg, mesh, tensor_parallel_rules(),
                                              ds.global_batch, ds.seq_len,
                                              dtype=torch.float32).summary()
    return out


def world_main(rank: int, world: int, in_path: str, root: str) -> dict:
    """Everything the port's tests ask of one world of 8 gloo ranks."""
    torch.set_num_threads(1)
    data = dict(np.load(in_path))
    mesh24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    mesh42 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    mesh81 = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
    out = {"moe": _moe(data, mesh24), "dp": _dp(data, mesh81),
           "elastic": _elastic(rank, mesh42, root), "tp": _tp_blocks(data, mesh24),
           "first_draws": _first_draws(mesh24)}
    for arch in TRAIN_ARCHS:
        out[arch] = _trainer(rank, data, arch, mesh24, mesh42, root)
    return out


def _tp_trainer(data, arch, mesh, root) -> dict:
    """The Trainer of ``arch`` (``train_setup``) on ``mesh`` under the TP
    rules, every step recorded: losses, gradient norms, state norms (with
    each state leaf's key path), the leaves the step computes on their
    "model" block, and what each step sent beside ``step_collectives``."""
    cfg, ds, leaves = train_setup(data, arch)
    steps = int(data["train/steps"])
    tc = TL.TrainerConfig(num_steps=steps, log_every=1, checkpoint_every=1000,
                          checkpoint_dir=os.path.join(root, arch))
    tr = numpy_trainer(leaves)(cfg, ds, tc, mesh=mesh)
    recs = recorded_steps(tr)
    for step in range(steps):
        tr._do_step(step)
    rows = tr.metrics_log
    lay = tr.layout
    return {"losses": [m["loss"] for m in rows], "grad_norms": [m["grad_norm"] for m in rows],
            "state_norms": state_norms(tr), "recorded": recs,
            "state_paths": ["/".join(map(str, p)) for p in TL._paths(tr._state())],
            "tp_leaves": ["/".join(map(str, p)) for p, c in zip(lay.paths, lay.compute_specs)
                          if "model" in c and not TL._is_expert(p)],
            "analytic": TL.step_collectives(cfg, mesh, tensor_parallel_rules(), ds.global_batch,
                                            ds.seq_len, dtype=torch.float32).summary()}


def _mesh_decode(data, mesh) -> dict:
    """Each "decode/archs" arch's ``decode_step`` on the rank's blocks of
    ``mesh``: its params in the compute layout of a decode step
    (``MeshLayout`` of the batch and one token a row, under the TP rules),
    its block of the "decode/" cache by ``dryrun.decode_cache_specs`` (its
    rows over "data", its positions over "model"), its rows of the tokens,
    at each of "decode/positions" (a 0-d int32) from the same cache: the
    logits (the rank's rows, every vocabulary column), the rank's block of
    each cache leaf after the step, and its specs."""
    from repro_torch.launch.dryrun import decode_cache_specs
    from repro_torch.models.model import decode_step

    rules = tensor_parallel_rules()
    out = {}
    for arch in json.loads(str(data["decode/archs"])):
        cfg = f32_config(arch)
        pre = f"decode/{arch}/"
        batch, capacity = data[pre + "token"].shape[0], int(data["decode/capacity"])
        lay = TL.MeshLayout(cfg, mesh, rules, batch, 1)
        like = param_defs(cfg)
        whole = [torch.from_numpy(data[f"{pre}p/{i}"]) for i in range(len(tree_flatten(like)))]
        params = tree_unflatten(like, [layout.block_of(w, mesh, c).clone()
                                       for w, c in zip(whole, lay.compute_specs)])
        specs = decode_cache_specs(cfg, mesh, rules, batch, capacity)
        token = layout.block_of(torch.from_numpy(data[pre + "token"]), mesh, lay.batch_spec)
        got = {"specs": {k: list(sp) for k, (_, sp) in specs.items()}}
        for pos in data["decode/positions"]:
            cache = {k: layout.block_of(torch.from_numpy(data[f"{pre}cache/{k}"]), mesh,
                                        sp).clone() for k, (_, sp) in specs.items()}
            with torch.inference_mode(), activate_mesh(mesh, rules), C.recording() as rec:
                logits, cache = decode_step(params, cache, token,
                                            torch.tensor(int(pos), dtype=torch.int32), cfg,
                                            capacity=capacity)
            got[int(pos)] = {"logits": logits.numpy(), "recorded": rec.summary(),
                             "cache": {k: v.numpy() for k, v in cache.items()}}
        out[arch] = got
    return out


def tp_world_main(rank: int, world: int, in_path: str, root: str) -> dict:
    """``tests/test_torch_distributed_tp.py``'s world of 8 gloo ranks on a
    2 x 4 mesh: the families' "tp/" blocks, the mesh decode step of each
    "decode/archs" arch and the Trainer of each "train/archs" arch."""
    torch.set_num_threads(1)
    data = dict(np.load(in_path))
    mesh24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {"tp": _tp_blocks(data, mesh24), "decode": _mesh_decode(data, mesh24)}
    for arch in json.loads(str(data["train/archs"])):
        out[arch] = _tp_trainer(data, arch, mesh24, root)
    return out


def fake_meshes() -> dict:
    """The production meshes under torch's fake process group, one world
    after another: 512 ranks, 256, then 100 (too few)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    out = {}
    for world in (512, 256, 100):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        try:
            for multi in (False, True):
                key = f"{world}/{'multi' if multi else 'single'}"
                try:
                    m = make_production_mesh(multi_pod=multi, device_type="cpu")
                    out[key] = {"shape": list(m.shape), "names": list(m.mesh_dim_names)}
                except RuntimeError as e:
                    out[key] = {"error": str(e)}
            host = make_host_mesh(device_type="cpu")
            out[f"{world}/host"] = {"shape": list(host.shape), "names": list(host.mesh_dim_names)}
        finally:
            dist.destroy_process_group()
    return out


def collectives_main(rank: int, world: int) -> dict:
    """Each collective of ``core.collectives`` once over a (1, 4) mesh, with
    a backward through it, recorded."""
    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6) * (rank + 1)
    out = {}
    with C.recording() as rec:
        for name, op in (("all_gather", lambda t: C.all_gather(t, mesh, "model", 0)),
                         ("all_reduce", lambda t: C.all_reduce(t, mesh, ("data", "model"))),
                         ("all_to_all", lambda t: C.all_to_all(t, mesh, "model", 0, 1))):
            xs = x.clone().requires_grad_()
            y = op(xs)
            out[name] = y.detach().numpy()
            y.sum().backward()
            out[f"grad_{name}"] = xs.grad.numpy()
    out["recorded"] = rec.summary()
    # gathers to the first ranks alone (a checkpoint save's) on a (2, 2) mesh
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    whole = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec in (("data", "model"), (("data", "model"), None), ("data", None)):
        with C.recording() as rec:
            got = layout.full_on_first(layout.block_of(whole, mesh22, spec).clone(), mesh22, spec)
        out[f"first/{spec}"] = (None if got is None else got.numpy(), rec.summary())
    return out


# the specs a (2, 2) world moves a (4, 4, 6) tensor between: an axis leaving one dim for another
# (one all-to-all), gathers, a gather and a slice on one axis, and back
RELAYOUT_CASES = (
    ((None, "model", "data"), (None, ("model", "data"), None)),
    ((None, ("model", "data"), None), (None, "model", "data")),
    (("data", "model", None), ("model", None, "data")),
    (("data", None, None), (None, ("model", "data"), None)),
    ((("data", "model"), None, None), (None, None, None)),
)


def full_ep(cfg):
    """deepseek-v3-671b's reduced config with the full config's expert axes
    ("model", then "data"): its experts split over both."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_axes=("model", "data")))


def relayout_main(rank: int, world: int, root: str) -> dict:
    """On a (2, 2) mesh: each ``RELAYOUT_CASES`` move of a (4, 4, 6) tensor
    from its block under the source to its block under the target, against
    the whole tensor's block, and what it sent against ``relayout_sends``;
    then two Adafactor steps of the mesh Trainer of deepseek-v3-671b's
    reduced config (f32, ``full_ep``) under the TP rules with fsdp (its
    expert leaves' "data" split moves onto their expert dim and back) and
    without."""
    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    whole = torch.arange(4 * 4 * 6, dtype=torch.float32).reshape(4, 4, 6)
    out = {"relayout": []}
    for src, dst in RELAYOUT_CASES:
        with C.recording() as rec:
            got = layout.relayout(layout.block_of(whole, mesh, src).clone(), mesh, src, dst)
        want = C.CollectiveStats()
        layout.relayout_sends(whole.shape, whole.dtype, mesh, src, dst, want)
        out["relayout"].append({"equal": bool(torch.equal(got, layout.block_of(whole, mesh, dst))),
                                "recorded": rec.summary(), "analytic": want.summary()})
    cfg = full_ep(f32_config("deepseek-v3-671b"))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    leaves = [t.float().numpy() for t in tree_flatten(
        init_model(cfg, torch.Generator().manual_seed(0), "cpu"))]
    for fsdp in (True, False):
        tc = TL.TrainerConfig(num_steps=2, log_every=1, checkpoint_every=1000,
                              checkpoint_dir=os.path.join(root, f"fsdp_{fsdp}_{rank}"))
        rules = tensor_parallel_rules(fsdp=fsdp)
        with activate_mesh(mesh, rules):
            tr = numpy_trainer(leaves)(cfg, ds, tc, mesh=mesh)
        recs = recorded_steps(tr)
        for step in range(2):
            tr._do_step(step)
        rows = tr.metrics_log
        moved = [p for p, s, c in zip(tr.layout.paths, tr.layout.param_specs,
                                      tr.layout.compute_specs)
                 if any(m[0] == "a2a" for m in layout._plan(s, c)[0])]
        out[f"fsdp={fsdp}"] = {
            "losses": [m["loss"] for m in rows], "grad_norms": [m["grad_norm"] for m in rows],
            "state_norms": state_norms(tr),
            "moved_by_all_to_all": ["/".join(map(str, p)) for p in moved],
            "recorded": recs[1],
            "analytic": TL.step_collectives(cfg, mesh, rules, ds.global_batch, ds.seq_len,
                                            dtype=torch.float32).summary()}
    return out
