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
  python tests/jax_reference_runs.py tp IN.npz OUT.npz        (8 devices)
      the families' "tp/" blocks on one device (MLA, the shared experts,
      Mamba2, hybrid's shared block, whisper's encoder and decoder blocks
      and cross-attention) and the Trainer of each "train/archs" arch on
      2 x 4, the reference's chunked SSD scan with its segments' exp
      masked, as the port's is (``masked_ssd``): its own gradients are NaN.
  python tests/jax_reference_runs.py flops B S OUT.json      (1 device)
      every arch's reduced config, its train step unrolled (no scan),
      naive attention, no remat, compiled at B x S on one device: the
      compiled module's ``cost_analysis()`` FLOPs.

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
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_reduced_config
    from repro.data.pipeline import make_batch
    from repro.models.moe import moe_apply
    from repro.sharding.rules import activate_mesh
    from repro.training.grad_compress import dp_value_and_grad

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
        bounds = []

        def int8_bound(tr, step):
            if step < 2:
                batch = make_batch(tr.cfg, tr.ds, step)
                bounds.append(int8_mean_bound(tr.params, batch, tr.cfg, 2))

        mesh_trainer(data, res, arch, mesh24, int(data["train/steps"]), before_step=int8_bound)
        res[f"train/{arch}/int8_bounds"] = np.asarray(bounds)
    np.savez(out_path, **res)


def case_config(data, case):
    """A "tp/" case's config, as ``torch_dist_workers.case_config`` builds
    the port's: its arch's reduced config (granite-3-8b where the case
    names none) in f32 with the case's overrides, the Mamba2 ones under
    "ssm"."""
    import dataclasses

    import jax.numpy as jnp

    from repro.configs import get_reduced_config

    arch = str(data.get(f"tp/{case}/arch", "granite-3-8b"))
    over = json.loads(str(data[f"tp/{case}/overrides"]))
    ssm = over.pop("ssm", None)
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=jnp.float32, **over)
    return cfg if ssm is None else dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))


def nest(flat):
    """{"a/b": leaf} → {"a": {"b": leaf}}."""
    out = {}
    for k, v in flat.items():
        *heads, last = k.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def tp_blocks(data, res):
    """Each "tp/" case's block on one device (``case_config``): its output,
    and the gradients (``jax.vjp`` with the case's cotangent) of its params,
    of its input x (not of an embedding's tokens) and of its extra input e
    where it takes one (hybrid's x0, whisper's encoder output)."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe, ssm
    from repro.models import transformer as T
    from repro.models.layers import (embed_apply, gqa_apply, gqa_cross_apply, mla_apply,
                                     mlp_apply)
    from repro.models.model import lm_loss

    for case in json.loads(str(data["tp/cases"])):
        kind = str(data[f"tp/{case}/kind"])
        cfg = case_config(data, case)
        prefix = f"tp/{case}/p/"
        params = nest({k[len(prefix):]: jnp.asarray(v) for k, v in data.items()
                       if k.startswith(prefix)})
        x, cot = jnp.asarray(data[f"tp/{case}/x"]), jnp.asarray(data[f"tp/{case}/cot"])
        if kind == "embed":
            y, vjp = jax.vjp(lambda p: embed_apply(p, x, cfg), params)
            (gp,) = vjp(cot)
        else:
            labels = jnp.asarray(data.get(f"tp/{case}/labels", 0))
            fn = {"gqa": lambda p, h, e: gqa_apply(p, h, cfg),
                  "mlp": lambda p, h, e: mlp_apply(p, h, cfg),
                  "loss": lambda p, h, e: lm_loss({"embed": p}, h, labels, cfg),
                  "mla": lambda p, h, e: mla_apply(p, h, cfg),
                  "shared_experts": lambda p, h, e: moe._shared_ffn(p, h, cfg),
                  "mamba": lambda p, h, e: ssm.mamba_apply(p, h, cfg),
                  "shared_attn": lambda p, h, e: T.shared_attn_apply(p, h, e, cfg),
                  "enc_block": lambda p, h, e: T.enc_block_apply(p, h, cfg)[0],
                  "dec_block": lambda p, h, e: T.dec_block_apply(p, h, e, cfg)[0],
                  "cross_attn": lambda p, h, e: gqa_cross_apply(p, h, T._cross_kv(p, e, cfg),
                                                                cfg)}[kind]
            if f"tp/{case}/e" in data:
                y, vjp = jax.vjp(fn, params, x, jnp.asarray(data[f"tp/{case}/e"]))
                gp, gx, ge = vjp(cot)
                res[f"tp/{case}/de"] = np.asarray(ge)
            else:
                y, vjp = jax.vjp(lambda p, h: fn(p, h, None), params, x)
                gp, gx = vjp(cot)
            res[f"tp/{case}/dx"] = np.asarray(gx)
        res[f"tp/{case}/y"] = np.asarray(y)
        for k, g in flat(gp).items():
            res[f"tp/{case}/d/{k}"] = np.asarray(g)


def masked_ssd():
    """Puts a copy of the reference's chunked SSD scan in its place, with
    the exp of the intra-chunk segments masked on both sides (the port's
    ``ssm._masked_exp``): the reference takes the exp of the positive
    differences above the diagonal and masks them after, so its backward
    multiplies 0 by inf and its gradients are NaN.  Kept entries are the
    same bits; the copy is otherwise the reference's, line for line."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm

    def ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=None):
        b, s, h, p = x.shape
        n = Bm.shape[-1]
        if s % chunk != 0:
            chunk = s
        nc = s // chunk
        xc = x.reshape(b, nc, chunk, h, p)
        dtc = dt.reshape(b, nc, chunk, h)
        Bc = Bm.reshape(b, nc, chunk, n)
        Cc = Cm.reshape(b, nc, chunk, n)
        cum = jnp.cumsum(dtc * A, axis=2)
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        tri = jnp.tril(jnp.ones((chunk, chunk), bool))[None, None, :, :, None]
        seg = jnp.where(tri, jnp.exp(jnp.where(tri, diff, 0.0)), 0.0)
        cb = jnp.einsum("bcin,bcjn->bcij", Cc, Bc)
        m = cb[:, :, :, :, None] * seg * dtc[:, :, None, :, :]
        y_intra = jnp.einsum("bcijh,bcjhp->bcihp", m, xc)
        decay_to_end = jnp.exp(cum[:, :, -1:, :] - cum)
        hc = jnp.einsum("bclh,bclhp,bcln->bchpn", decay_to_end * dtc, xc, Bc)
        chunk_decay = jnp.exp(cum[:, :, -1, :])

        def step(h_prev, inp):
            cd, hck = inp
            return h_prev * cd[:, :, None, None] + hck, h_prev

        if h0 is None:
            h0 = jnp.zeros((b, h, p, n), jnp.float32)
        h_final, h_in = jax.lax.scan(step, h0, (chunk_decay.swapaxes(0, 1), hc.swapaxes(0, 1)))
        y_inter = jnp.einsum("bcin,bchpn->bcihp", Cc, h_in.swapaxes(0, 1)) * jnp.exp(cum)[
            :, :, :, :, None]
        return (y_intra + y_inter).reshape(b, s, h, p), h_final

    ssm.ssd_chunked = ssd_chunked


def mesh_trainer(data, res, arch, mesh, steps, before_step=None):
    """The reference's Trainer of ``arch``'s reduced config in f32 on
    ``mesh`` from the "train/{arch}/" leaves, ``steps`` steps: losses,
    gradient norms, learning rates and each state leaf's norm at the end.
    Where "train/{arch}/frames/{step}" are given, its batches carry those
    front-end frames (the port draws its stubs with torch, the reference
    with ``jax.random``).  ``before_step(trainer, step)``, where given, runs ahead of
    each step."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import param_defs
    from repro.data.pipeline import make_batch
    from repro.training import train_loop as TL
    from repro.training.optimizer import init_opt_state
    from repro.training.train_loop import Trainer, TrainerConfig

    tcfg = dataclasses.replace(get_reduced_config(arch), dtype=jnp.float32)
    ds = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=int(data["train/seq"]),
                     global_batch=int(data["train/batch"]))
    if f"train/{arch}/frames/0" in data:  # the port's front-end stubs, drawn by torch
        frames = lambda step: jnp.asarray(data[f"train/{arch}/frames/{step}"])  # noqa: E731
        TL.make_batch = lambda cfg, ds, step: dict(make_batch(cfg, ds, step),
                                                   frontend_embeds=frames(step))
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(num_steps=steps, log_every=1, checkpoint_every=1000, checkpoint_dir=d)
        tr = Trainer(tcfg, ds, tc, mesh=mesh)
        treedef = jax.tree.structure(tr.params)
        tr.params = jax.tree.unflatten(
            treedef, [jnp.asarray(data[f"train/{arch}/{i}"]) for i in range(treedef.num_leaves)])
        tr.opt_state = init_opt_state(tcfg.optimizer, param_defs(tcfg), tr.params,
                                      jax.random.PRNGKey(0))
        for step in range(steps):
            if before_step is not None:
                before_step(tr, step)
            tr._do_step(step)
    rows = tr.metrics_log
    res[f"train/{arch}/losses"] = np.asarray([m["loss"] for m in rows])
    res[f"train/{arch}/grad_norms"] = np.asarray([m["grad_norm"] for m in rows])
    res[f"train/{arch}/lrs"] = np.asarray([m["lr"] for m in rows])
    res[f"train/{arch}/state_norms"] = np.asarray(
        [np.linalg.norm(np.asarray(t, np.float64)) for t in jax.tree.leaves(tr._state())])
    return tr


def decode_steps(data, res):
    """Each "decode/archs" arch's ``decode_step`` on one device, its
    reduced config in f32, from the "decode/" params (the port's leaves in
    ``jax.tree`` order), cache and tokens, jitted once with ``pos`` an
    argument and run at each of "decode/positions" from the same cache:
    the logits and every cache leaf after the step."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models.model import decode_step, param_defs
    from repro.models.params import abstract_params

    for arch in json.loads(str(data["decode/archs"])):
        cfg = dataclasses.replace(get_reduced_config(arch), dtype=jnp.float32)
        pre = f"decode/{arch}/"
        treedef = jax.tree.structure(abstract_params(param_defs(cfg)))
        params = jax.tree.unflatten(
            treedef, [jnp.asarray(data[f"{pre}p/{i}"]) for i in range(treedef.num_leaves)])
        cache = {k[len(pre + "cache/"):]: jnp.asarray(v) for k, v in data.items()
                 if k.startswith(pre + "cache/")}
        step = jax.jit(lambda p, c, t, pos: decode_step(p, c, t, pos, cfg))
        for pos in data["decode/positions"]:
            logits, out = step(params, cache, jnp.asarray(data[pre + "token"]), jnp.int32(pos))
            res[f"{pre}{int(pos)}/logits"] = np.asarray(logits)
            for k, v in out.items():
                res[f"{pre}{int(pos)}/cache/{k}"] = np.asarray(v)


def tp_mode(in_path, out_path):
    """The families' tensor-parallel cases: the "tp/" blocks and each
    "decode/archs" arch's decode step on one device, and the Trainer of
    each "train/archs" arch on 2 x 4, the SSD scan's gradient finite
    (``masked_ssd``)."""
    import jax
    from jax.sharding import Mesh

    masked_ssd()
    data = dict(np.load(in_path))
    res = {}
    tp_blocks(data, res)
    decode_steps(data, res)
    mesh24 = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    for arch in json.loads(str(data["train/archs"])):
        mesh_trainer(data, res, arch, mesh24, int(data["train/steps"]))
    np.savez(out_path, **res)


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


def flops_mode(batch, seq, out_path):
    """Each arch's reduced config's train step, unrolled, compiled on one
    device at ``batch`` x ``seq``, and its decode step at ``batch`` rows
    over a cache of ``seq`` positions: {arch: the train step's
    cost_analysis FLOPs, "decode/" + arch: the decode step's}."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config, list_archs
    from repro.models.model import decode_step, param_defs
    from repro.models.params import abstract_params
    from repro.serving.kv_cache import cache_defs
    from repro.training.optimizer import opt_state_defs
    from repro.training.train_loop import make_train_step

    out = {}
    for arch in list_archs():
        cfg = dataclasses.replace(get_reduced_config(arch), scan_layers=False,
                                  attention_impl="naive", remat="none")
        defs = param_defs(cfg)
        tok = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
        b = {"tokens": tok, "labels": tok}
        rows = {"vision": cfg.frontend_seq, "audio": cfg.encoder_seq}.get(cfg.frontend)
        if rows is not None:
            b["frontend_embeds"] = jax.ShapeDtypeStruct((batch, rows, cfg.d_model), cfg.dtype)
        compiled = jax.jit(make_train_step(cfg)).lower(
            abstract_params(defs), abstract_params(opt_state_defs(cfg.optimizer, defs)), b,
            jax.ShapeDtypeStruct((), jnp.int32)).compile()
        out[arch] = float((compiled.cost_analysis() or {})["flops"])
        compiled = jax.jit(lambda p, c, t, pos: decode_step(p, c, t, pos, cfg)).lower(
            abstract_params(defs), abstract_params(cache_defs(cfg, batch=batch, max_len=seq)),
            jax.ShapeDtypeStruct((batch, 1), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32)).compile()
        out[f"decode/{arch}"] = float((compiled.cost_analysis() or {})["flops"])
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "rules":
        rules_mode(sys.argv[2])
    elif sys.argv[1] == "flops":
        flops_mode(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1] == "tp":
        tp_mode(sys.argv[2], sys.argv[3])
    else:
        dist_mode(sys.argv[2], sys.argv[3])
