"""The JAX package's side of the multi-device parity tests, run as a script
in a subprocess with forced host devices (the test process keeps JAX's one
CPU device):

  python tests/jax_reference_runs.py rules OUT.json          (512 devices)
      every arch's param and optimizer-state specs and shard shapes on
      (16, 16) and (2, 16, 16) under the three rule sets; every arch × shape
      cell's input and cache specs and resident bytes; the dry run's
      arithmetic (default fsdp, model FLOPs).  Nothing is compiled.
  python tests/jax_reference_runs.py dist IN.npz OUT.npz      (8 devices)
      the sharded MoE (2 x 4), dp_value_and_grad (8 x 1) and the Trainer on
      2 x 4 (losses, gradient norms, each state leaf's norm, and a bound on
      what the int8 all-reduce over "data" can move the gradient of the first
      two steps), from the weights and inputs in IN.npz; and on one device,
      each "tp/" case's block (GQA, the MLP, the embedding, the LM loss) with
      its gradient, the cotangent given.

Specs are written as lists with one entry a dim: null, an axis name, or a
list of names."""
import json
import sys
import tempfile

import numpy as np


def spec_entries(spec, ndim):
    entries = list(spec) + [None] * (ndim - len(spec))
    return [e if e is None or isinstance(e, str) else list(e) for e in entries]


def rules_mode(out_path):
    import jax
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import SHAPES, get_config, input_specs, list_archs
    from repro.launch.dryrun import default_fsdp, iter_cells, model_flops_of
    from repro.launch.dryrun import resident_bytes_per_device
    from repro.models.model import param_defs
    from repro.models.params import abstract_params
    from repro.sharding.rules import activate_mesh, make_rules, spec_for
    from repro.training.optimizer import opt_state_defs
    from repro.training.train_loop import abstract_state

    devs = np.asarray(jax.devices())
    meshes = {"16x16": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
              "2x16x16": Mesh(devs[:512].reshape(2, 16, 16), ("pod", "data", "model"))}
    rulesets = {"tp": ("tp", False), "tp_fsdp": ("tp", True), "fsdp_only": ("fsdp_only", False)}
    out = {"params": {}, "opt": {}, "cells": {}, "fsdp": {}, "model_flops": {},
           "iter_cells": [list(c) for c in iter_cells()]}

    def leaves(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return [[jax.tree_util.keystr(p), spec_entries(l.sharding.spec, len(l.shape)),
                 list(l.sharding.shard_shape(l.shape)), list(l.shape), str(l.dtype)]
                for p, l in flat]

    for arch in list_archs():
        cfg = get_config(arch)
        out["fsdp"][arch] = default_fsdp(cfg)
        out["model_flops"][arch] = {s: model_flops_of(cfg, s) for s in SHAPES}
        defs = param_defs(cfg)
        odefs = opt_state_defs(cfg.optimizer, defs)
        for tree, key in ((defs, "params"), (odefs, "opt")):
            out[key][arch] = {}
            for mname, mesh in meshes.items():
                out[key][arch][mname] = {}
                for rname, (par, fsdp) in rulesets.items():
                    rules = make_rules(par, fsdp=fsdp)
                    sh = lambda d: NamedSharding(mesh, spec_for(d, mesh, rules))  # noqa: E731
                    out[key][arch][mname][rname] = leaves(abstract_params(tree, sh))
        out["cells"][arch] = {}
        for shape_id, sh_cfg in SHAPES.items():
            out["cells"][arch][shape_id] = {}
            for mname, mesh in meshes.items():
                row = out["cells"][arch][shape_id][mname] = {}
                for rname, (par, fsdp) in rulesets.items():
                    rules = make_rules(par, fsdp=fsdp)
                    with activate_mesh(mesh, rules):
                        inputs = input_specs(cfg, shape_id, mesh)
                        if sh_cfg["kind"] == "train":
                            p_abs, o_abs = abstract_state(cfg, mesh, rules)
                            everything = (p_abs, o_abs, inputs)
                        else:
                            shard = lambda d: NamedSharding(  # noqa: E731
                                mesh, spec_for(d, mesh, rules))
                            everything = (abstract_params(defs, shard), inputs)
                    row[rname] = {"inputs": leaves(inputs),
                                  "resident": resident_bytes_per_device(everything)}
    with open(out_path, "w") as f:
        json.dump(out, f)


def dist_mode(in_path, out_path):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_reduced_config
    from repro.data.pipeline import SyntheticLM, make_batch
    from repro.models.model import param_defs
    from repro.models.moe import moe_apply
    from repro.sharding.rules import activate_mesh
    from repro.training.grad_compress import dp_value_and_grad
    from repro.training.optimizer import init_opt_state
    from repro.training.train_loop import Trainer, TrainerConfig

    data = dict(np.load(in_path))
    res = {}
    devs = np.asarray(jax.devices())
    mesh24 = Mesh(devs.reshape(2, 4), ("data", "model"))

    cfg = get_reduced_config("granite-moe-3b-a800m")
    params = {k: jnp.asarray(data[f"moe/{k}"]) for k in ("router", "wg", "wu", "wd")}
    fn = jax.jit(lambda p, x: moe_apply(p, x, cfg))
    for case in ("a2a", "a2a_split", "gather"):
        with activate_mesh(mesh24):
            y, aux = fn(params, jnp.asarray(data[f"moe/x_{case}"]))
        res[f"moe/{case}/y"] = np.asarray(y)
        res[f"moe/{case}/aux"] = np.asarray(aux)

    mesh81 = Mesh(devs.reshape(8, 1), ("data", "model"))
    p = {"w": jnp.asarray(data["dp/w"])}
    batch = {"x": jnp.asarray(data["dp/x"]), "y": jnp.asarray(data["dp/y"])}

    def loss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    for name, compressed in (("exact", False), ("compressed", True)):
        with mesh81:
            l, g = jax.jit(dp_value_and_grad(loss, mesh81, compressed=compressed))(p, batch)
        res[f"dp/{name}/loss"] = np.asarray(l)
        res[f"dp/{name}/g"] = np.asarray(g["w"])

    tp_blocks(data, res)

    for arch in ("granite-3-8b", "granite-moe-3b-a800m"):
        tcfg = dataclasses.replace(get_reduced_config(arch), dtype=jnp.float32)
        ds = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=int(data["train/seq"]),
                         global_batch=int(data["train/batch"]))
        steps = int(data["train/steps"])
        with tempfile.TemporaryDirectory() as d:
            tc = TrainerConfig(num_steps=steps, log_every=1, checkpoint_every=1000,
                               checkpoint_dir=d)
            tr = Trainer(tcfg, ds, tc, mesh=mesh24)
            treedef = jax.tree.structure(tr.params)
            n = treedef.num_leaves
            tr.params = jax.tree.unflatten(
                treedef, [jnp.asarray(data[f"train/{arch}/{i}"]) for i in range(n)])
            tr.opt_state = init_opt_state(tcfg.optimizer, param_defs(tcfg), tr.params,
                                          jax.random.PRNGKey(0))
            bounds = []
            for step in range(steps):
                if step < 2:
                    bounds.append(int8_mean_bound(tr.params, make_batch(tcfg, ds, step), tcfg, 2))
                tr._do_step(step)
        rows = tr.metrics_log
        res[f"train/{arch}/losses"] = np.asarray([m["loss"] for m in rows])
        res[f"train/{arch}/grad_norms"] = np.asarray([m["grad_norm"] for m in rows])
        res[f"train/{arch}/lrs"] = np.asarray([m["lr"] for m in rows])
        res[f"train/{arch}/int8_bounds"] = np.asarray(bounds)
        res[f"train/{arch}/state_norms"] = np.asarray(
            [np.linalg.norm(np.asarray(t, np.float64)) for t in jax.tree.leaves(tr._state())])
    np.savez(out_path, **res)


def tp_blocks(data, res):
    """Each "tp/" case's block on one device, the reduced granite-3-8b in f32
    with the case's overrides: its output, and the gradients (``jax.vjp``
    with the case's cotangent) of its params and of its input x (not of an
    embedding's tokens)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models.layers import embed_apply, gqa_apply, mlp_apply
    from repro.models.model import lm_loss

    base = get_reduced_config("granite-3-8b")
    for case in json.loads(str(data["tp/cases"])):
        kind = str(data[f"tp/{case}/kind"])
        cfg = dataclasses.replace(base, dtype=jnp.float32,
                                  **json.loads(str(data[f"tp/{case}/overrides"])))
        prefix = f"tp/{case}/p/"
        params = {k[len(prefix):]: jnp.asarray(v) for k, v in data.items() if k.startswith(prefix)}
        x, cot = jnp.asarray(data[f"tp/{case}/x"]), jnp.asarray(data[f"tp/{case}/cot"])
        if kind == "embed":
            y, vjp = jax.vjp(lambda p: embed_apply(p, x, cfg), params)
            (gp,) = vjp(cot)
        else:
            labels = jnp.asarray(data.get(f"tp/{case}/labels", 0))
            fn = {"gqa": lambda p, h: gqa_apply(p, h, cfg),
                  "mlp": lambda p, h: mlp_apply(p, h, cfg),
                  "loss": lambda p, h: lm_loss({"embed": p}, h, labels, cfg)}[kind]
            y, vjp = jax.vjp(fn, params, x)
            gp, gx = vjp(cot)
            res[f"tp/{case}/dx"] = np.asarray(gx)
        res[f"tp/{case}/y"] = np.asarray(y)
        for k, g in gp.items():
            res[f"tp/{case}/d/{k}"] = np.asarray(g)


def int8_mean_bound(params, batch, cfg, n_dp):
    """A bound on the L2 distance between the exact mean gradient and the int8
    one over ``n_dp`` data-parallel ranks, each holding its consecutive
    slice of the batch: each rank's entry moves at most half its scale
    (amax / 127) when quantized, so the mean moves at most half the largest
    rank's scale, with each leaf's amax over the whole leaf (at least any
    block's of it)."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import train_loss

    grad = jax.jit(jax.grad(lambda p, b: train_loss(p, b, cfg)[0]))
    amax = None
    rows = batch["tokens"].shape[0] // n_dp
    for r in range(n_dp):
        part = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
        a = [jnp.max(jnp.abs(g.astype(jnp.float32))) for g in jax.tree.leaves(grad(params, part))]
        amax = a if amax is None else [jnp.maximum(x, y) for x, y in zip(amax, a)]
    sq = sum(float(np.asarray(m)) ** 2 / 127.0 ** 2 / 4 * g.size
             for m, g in zip(amax, jax.tree.leaves(params)))
    return np.sqrt(sq)


if __name__ == "__main__":
    if sys.argv[1] == "rules":
        rules_mode(sys.argv[2])
    else:
        dist_mode(sys.argv[2], sys.argv[3])
