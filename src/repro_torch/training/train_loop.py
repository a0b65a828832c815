"""Training loop: the train step and the Trainer, with fault tolerance.

``make_train_step`` builds train_step(params, opt_state, batch, step) →
(params, opt_state, metrics), the reference's (``repro.training.train_loop``)
on one device: microbatch gradient accumulation (``accum``, a loop over
batch slices where the reference scans), AdamW / Adafactor by
``cfg.optimizer``, the cosine schedule and the global-norm clip.  The params
and the optimizer state are updated in place (the reference donates them)
and returned.  ``state_shardings`` and ``abstract_state`` lay the state out
on a mesh by the sharding rules, as the reference's do.

``Trainer`` drives it: data → step → metrics / checkpoints / fault handling
(checkpoint every N steps on a thread, straggler detection, restart on a
``WorkerFailure`` with the data replayed from the restored step).

On a mesh (``Trainer(..., mesh=)``, SPMD: every rank of the mesh runs the
same Trainer) the params and the optimizer state are DTensors laid out by
``state_shardings``, each rank holding its shard (drawn leaf by leaf, each
rank keeping its block), and each rank trains on its ``batch_spec`` slice
of ``make_batch``.  The step computes as the reference's partitioned step
does (``_compute_spec``): every family keeps each leaf's "model" split
(heads, kv_heads, mlp, vocab, Mamba2's inner and ssm_heads) and computes
each layer on the rank's shard (``models/layers.py``: GQA, MLA, the MLPs
and the shared experts, the embedding and the loss; ``models/ssm.py``:
Mamba2), gathering only the fsdp split over "data"; a Mamba2 block whose
heads do not divide "model" computes whole (a rank holds whole heads); the
MoE expert leaves take the expert axes the sharded MoE body takes; every
other leaf is gathered whole.  Every rank's backward starts from its own loss; the
collectives carry their transposes, so a leaf's gradient is the sum over the
ranks that share its block, divided by the mesh size (``_grad_plan``; a
split leaf's gradient has the "model" ranks' losses in it through the
backward of the sum over "model", ``core.collectives``): a reduce-scatter
over an axis that splits the leaf's storage, an all-reduce over one that
does not, or over the DP axes the int8 all-reduce
(``TrainerConfig.grad_compress``), in the gradient's dtype.  Each rank then keeps its shard:
the global-norm clip all-reduces the shards' sums of squares, each block
counted once; AdamW updates the local shards; Adafactor updates a leaf at
a time with its factored dims whole and its layers and experts split
(``adafactor_specs``), the moments and the clip the whole leaf's, and each
rank keeps its shard of them.
``step_collectives`` counts what a step sends.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as C
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import moe
from repro_torch.models.model import init_model, param_defs, train_loss
from repro_torch.models.params import (
    ParamDef,
    abstract_params,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from repro_torch.sharding import layout
from repro_torch.sharding.rules import (
    MODEL,
    ShardingRules,
    activate_mesh,
    active_rules,
    axis_sizes,
    batch_axes,
    batch_spec,
    entry_axes,
    shard_shape,
    spec_for,
    spec_placements,
)
from repro_torch.training import grad_compress
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault import StragglerDetector, WorkerFailure, run_with_restarts
from repro_torch.training.optimizer import (
    CLIP_NORM,
    Schedule,
    adafactor_beta2,
    adafactor_leaf,
    adamw_update,
    clip_by_global_norm,
    factored,
    init_opt_state,
    opt_state_defs,
    opt_state_from_defs,
    opt_update,
)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------
def _grads_of(params, batch, cfg: ArchConfig):
    """(loss, metrics, grads) of ``train_loss``; the grads in the params'
    dtypes, zeros for a leaf the loss does not reach (as JAX gives)."""
    leaves = tree_flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = train_loss(tree_unflatten(params, xs), batch, cfg)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def loss_and_grads(cfg: ArchConfig, params, batch, accum: int = 1):
    """(loss, metrics, grads) over ``batch`` in ``accum`` microbatches: the
    loss and the grads are the microbatches' means, summed into f32 zeros
    (each microbatch's grads divided by ``accum`` in their own dtype first,
    as the reference does; ``.grad`` accumulation would sum bf16 leaves in
    bf16); the metrics are the last microbatch's."""
    if accum == 1:
        return _grads_of(params, batch, cfg)
    mb = batch["tokens"].shape[0] // accum
    dev = batch["tokens"].device
    count = torch.full((), accum, dtype=torch.float32, device=dev)  # a true division on the card
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_flatten(params)]
    for i in range(accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l, metrics, g = _grads_of(params, micro, cfg)
        loss = loss + l / count
        for acc, gi in zip(grads, tree_flatten(g)):
            acc.add_(gi / count)
        del g
    return loss, metrics, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, schedule: Schedule | None = None, *, accum: int = 1):
    """Returns train_step(params, opt_state, batch, step), updating params
    and opt_state in place."""
    schedule = schedule or Schedule()

    def train_step(params, opt_state, batch, step):
        _, metrics, grads = loss_and_grads(cfg, params, batch, accum)
        grads, gnorm = clip_by_global_norm(grads)
        lr = schedule(step)
        params, opt_state = opt_update(cfg.optimizer, params, grads, opt_state, lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sharding:
    """The reference's ``NamedSharding``: a mesh and a spec, with its DTensor
    placements."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return spec_placements(self.spec, self.mesh)


def state_shardings(cfg: ArchConfig, mesh, rules: ShardingRules):
    """``Sharding``s for (params, opt_state) from their ParamDef trees."""
    defs = param_defs(cfg)
    odefs = opt_state_defs(cfg.optimizer, defs)
    fn = lambda d: Sharding(mesh, spec_for(d, mesh, rules))  # noqa: E731
    return tree_map(fn, defs), tree_map(fn, odefs)


def abstract_state(cfg: ArchConfig, mesh, rules: ShardingRules):
    """(params, opt_state) as ``AbstractLeaf``s with their specs — dry-run inputs."""
    defs = param_defs(cfg)
    odefs = opt_state_defs(cfg.optimizer, defs)
    fn = lambda d: spec_for(d, mesh, rules)  # noqa: E731
    return abstract_params(defs, fn), abstract_params(odefs, fn)


def _is_expert(path: tuple) -> bool:
    """A stacked expert leaf: ``.../moe/{wg,wu,wd}``."""
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in ("wg", "wu", "wd")


def _paths(tree, prefix=()) -> list:
    """Each leaf's key path, in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [p for i, v in enumerate(tree) for p in _paths(v, prefix + (i,))]
    return [prefix]


TP_LOGICAL = ("heads", "kv_heads", "mlp", "vocab", "inner", "ssm_heads")  # split by a TP body


def _mamba_heads_split(cfg: ArchConfig, mesh, rules: ShardingRules) -> bool:
    """Whether a Mamba2 block's ``ssm_heads`` (and with them its ``inner``
    columns, a head's ``head_dim`` each) split over "model" under
    ``rules``: a rank holds whole heads or the block computes whole."""
    s = cfg.ssm
    heads = ParamDef((s.num_heads(cfg.d_model),), ("ssm_heads",))
    return MODEL in spec_for(heads, mesh, rules)


def _compute_spec(cfg: ArchConfig, path: tuple, d: ParamDef, store: tuple, mesh,
                  rules: ShardingRules, local_batch: int, seq: int) -> tuple:
    """The layout a leaf takes for the step, from its storage layout
    ``store``: an expert leaf's expert dim over the expert axes ``moe_apply``
    picks for the rank's tokens; a TP dim's "model" split kept (unless
    "model" is a DP axis of ``rules``, or the leaf is a Mamba2 block's whose
    heads do not split: ``inner`` would then cut a head in two); every
    other split (fsdp's "embed" over "data") gathered."""
    spec = [None] * len(d.shape)
    if _is_expert(path):
        ep_axes = moe.sharded_plan(cfg, mesh, local_batch, seq)[0]
        spec[d.logical.index("experts")] = moe._e_spec(ep_axes)[0]
    elif MODEL not in rules.dp_axes and not (
            "mamba" in path and not _mamba_heads_split(cfg, mesh, rules)):
        for i, (logical, e) in enumerate(zip(d.logical, store)):
            if logical in TP_LOGICAL and MODEL in entry_axes(e):
                spec[i] = MODEL
    return tuple(spec)


@dataclasses.dataclass
class MeshLayout:
    """Where each state leaf lives on ``mesh`` (its storage spec) and the
    layout the step computes it in, with the rank's batch slice."""

    cfg: ArchConfig
    mesh: object
    rules: ShardingRules
    global_batch: int
    seq: int
    accum: int = 1

    def __post_init__(self):
        defs = param_defs(self.cfg)
        odefs = opt_state_defs(self.cfg.optimizer, defs)
        self.param_defs = tree_flatten(defs)
        self.opt_defs = tree_flatten(odefs)
        self.param_specs = [spec_for(d, self.mesh, self.rules) for d in self.param_defs]
        self.opt_specs = [spec_for(d, self.mesh, self.rules) for d in self.opt_defs]
        self.batch_spec = batch_spec(self.global_batch, self.mesh, rules=self.rules)
        sizes = axis_sizes(self.mesh)
        self.local_batch = self.global_batch // math.prod(
            sizes[a] for a in entry_axes(self.batch_spec[0]))
        mb = self.local_batch // self.accum
        self.paths = _paths(defs)
        self.opt_paths = _paths(odefs)
        self.compute_specs = [
            _compute_spec(self.cfg, p, d, s, self.mesh, self.rules, mb, self.seq)
            for p, d, s in zip(self.paths, self.param_defs, self.param_specs)]
        self.dp = batch_axes(self.mesh, self.rules)

    def keep(self):
        """``init_model``'s ``keep``: a copy of this rank's block of a whole
        param leaf, by its key path, so that the whole leaf can be freed."""
        specs = dict(zip(self.paths, self.param_specs))
        return lambda path, t: layout.block_of(t, self.mesh, specs[path]).clone(
            memory_format=torch.contiguous_format)

    def local_opt_defs(self, defs: dict) -> dict:
        """The optimizer state's ParamDefs with this rank's block shapes."""
        local = [dataclasses.replace(d, shape=shard_shape(d.shape, sp, self.mesh))
                 for d, sp in zip(self.opt_defs, self.opt_specs)]
        return tree_unflatten(opt_state_defs(self.cfg.optimizer, defs), local)

    def wrap(self, blocks: list, specs) -> list:
        """DTensors of this rank's blocks."""
        return [DTensor.from_local(b, self.mesh, spec_placements(sp, self.mesh), run_check=False)
                for b, sp in zip(blocks, specs)]

    def batch_slice(self, batch: dict) -> dict:
        return {k: layout.block_of(v, self.mesh, self.batch_spec + (None,) * (v.dim() - 2))
                for k, v in batch.items()}

    def reduce_grad(self, g: torch.Tensor, spec, store, compressed: bool) -> torch.Tensor:
        """This rank's shard (layout ``store``) of the step's gradient of a
        leaf computed in layout ``spec``: the sum over the ranks that share
        its block (``_grad_plan``), divided by the mesh size, in the
        gradient's dtype (the int8 path quantizes from f32)."""
        sizes = axis_sizes(self.mesh)
        ops, now, dp = _grad_plan(spec, store, sizes, self.dp, compressed)
        for axis, dim in ops:
            g = (C.all_reduce(g, self.mesh, axis) if dim is None
                 else C.reduce_scatter(g, self.mesh, axis, dim))
        n = math.prod(sizes.values()) // math.prod(sizes[a] for a in dp)
        g = g / torch.full((), n, dtype=torch.float32, device=g.device)
        if compressed:
            g = grad_compress._int8_pmean(g, self.mesh, dp)
        return layout.relayout(g, self.mesh, now, store)


def mesh_state(lay: MeshLayout, params) -> tuple:
    """(params, opt_state) as DTensors of this rank's blocks, from the
    blocks ``params`` (``init_model(..., keep=lay.keep())``'s), the
    optimizer state drawn for them."""
    opt_state = opt_state_from_defs(lay.local_opt_defs(param_defs(lay.cfg)), params)
    return (tree_unflatten(params, lay.wrap(tree_flatten(params), lay.param_specs)),
            tree_unflatten(opt_state, lay.wrap(tree_flatten(opt_state), lay.opt_specs)))


def _grad_plan(spec, store, sizes: dict, dp_axes, compressed: bool) -> tuple:
    """How a gradient computed in layout ``spec`` is summed over the axes
    that replicate it: ``[(axis, dim)]`` in mesh order, a reduce-scatter
    along ``dim`` where the storage layout ``store`` splits ``dim`` over
    ``axis`` next, an all-reduce (``dim`` None) elsewhere; the layout it
    ends in; and, with ``compressed``, the DP axes left to the int8 mean."""
    now = [entry_axes(e) for e in spec]
    used = {a for e in now for a in e}
    ops, dp = [], []
    for axis in sizes:
        if axis in used:
            continue
        if compressed and axis in dp_axes:
            dp.append(axis)
            continue
        dim = next((i for i, e in enumerate(store)
                    if entry_axes(e)[:len(now[i]) + 1] == now[i] + (axis,)), None)
        if dim is not None:
            now[dim] = now[dim] + (axis,)
        ops.append((axis, dim))
    spec_now = tuple(None if not a else (a[0] if len(a) == 1 else a) for a in now)
    return ops, spec_now, tuple(dp)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _global_norm(grads: list, specs: list, mesh) -> torch.Tensor:
    """The norm of the whole gradient from the ranks' shards: each block's
    sum of squares counted by one rank (``layout.first_replica``), summed
    over the mesh."""
    dev = grads[0].device
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for g, sp in zip(grads, specs):
        if layout.first_replica(mesh, sp):
            sq = sq + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(C.all_reduce(sq, mesh, tuple(axis_sizes(mesh))))


def make_mesh_step(cfg: ArchConfig, lay: MeshLayout, schedule: Schedule | None = None, *,
                   compressed: bool = False):
    """Returns train_step(params, opt_state, batch, step) for one rank of
    ``lay.mesh``: the state trees of DTensors (updated in place on their
    local shards), ``batch`` the rank's slice.  The metrics are the mesh's
    means."""
    schedule = schedule or Schedule()
    mesh = lay.mesh

    def train_step(params, opt_state, batch, step):
        with torch.no_grad():
            compute = [layout.relayout(_local(p), mesh, s, c)
                       for p, s, c in zip(tree_flatten(params), lay.param_specs,
                                          lay.compute_specs)]
        with activate_mesh(mesh, lay.rules):
            _, metrics, grads = loss_and_grads(cfg, tree_unflatten(params, compute), batch,
                                               lay.accum)
        del compute
        with torch.no_grad():
            names = sorted(metrics)
            stacked = torch.stack([metrics[k].to(torch.float32) for k in names])
            stacked = C.all_reduce(stacked, mesh, tuple(axis_sizes(mesh))) / torch.full(
                (), mesh.size(), dtype=torch.float32, device=stacked.device)
            metrics = dict(zip(names, stacked.unbind(0)))
            shards = [lay.reduce_grad(g, c, s, compressed) for g, c, s in
                      zip(tree_flatten(grads), lay.compute_specs, lay.param_specs)]
            del grads
            gnorm = _global_norm(shards, lay.param_specs, mesh)
            scale = torch.clamp_max(torch.full_like(gnorm, CLIP_NORM)
                                    / torch.clamp_min(gnorm, 1e-9), 1.0)
            lr = schedule(step)
            local_params = [_local(p) for p in tree_flatten(params)]
            shards = [(g.to(torch.float32) * scale).to(p.dtype)
                      for g, p in zip(shards, local_params)]
            if cfg.optimizer == "adamw":
                local_state = tree_unflatten(opt_state, [_local(t) for t in
                                                         tree_flatten(opt_state)])
                adamw_update(tree_unflatten(params, local_params),
                             tree_unflatten(params, shards), local_state, lr)
            else:
                _adafactor_on_mesh(lay, params, opt_state, shards, lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def adafactor_specs(shape: tuple, spec: tuple, compute: tuple, sizes: dict) -> tuple:
    """(the param's, its row moment's, its column moment's) layouts for
    Adafactor's update of a leaf stored in ``spec`` and computed in
    ``compute`` on a mesh of ``sizes``: its two trailing (factored) dims
    whole, its leading dims (layers, experts) split as ``compute`` splits
    them where the compute layout keeps the trailing dims whole and splits
    more (an expert leaf: a rank updates its own experts), else as ``spec``
    does, and each axis that split the trailing dims in ``spec`` moved onto
    the first leading dim whose block it divides (a stacked leaf: a rank
    updates its own layers).  A leaf that is not factored is updated in
    its storage layout."""
    if not factored(shape):
        return tuple(spec), tuple(spec), (None,)
    lead = tuple(spec[:-2])
    if (tuple(compute[-2:]) == (None, None)
            and set(_split_axes(compute[:-2])) > set(_split_axes(lead))):
        lead = tuple(compute[:-2])
    axes = [list(entry_axes(e)) for e in lead]
    for ax in _split_axes(spec[-2:]):
        if ax in _split_axes(lead):
            continue
        for a, n in zip(axes, shape[:-2]):
            if (n // math.prod(sizes[b] for b in a)) % sizes[ax] == 0:
                a.append(ax)
                break
    lead = tuple(None if not a else (a[0] if len(a) == 1 else tuple(a)) for a in axes)
    return lead + (None, None), lead + (None,), lead + (None,)


def _split_axes(spec: tuple) -> tuple:
    """The mesh axes that split a tensor laid out in ``spec``."""
    return tuple(a for e in spec for a in entry_axes(e))


def _adafactor_on_mesh(lay: MeshLayout, params, opt_state, shards, lr) -> None:
    """Adafactor on the rank's blocks, one leaf at a time: the param, the
    gradient and the moments relayouted to ``adafactor_specs`` (the
    factored dims whole, so that the row and column means are the whole
    leaf's), the clip's sum of squares summed over the axes that split
    that layout, the rank's storage blocks kept.  No leaf is gathered along
    its leading dims where its layout lets a rank hold its own layers' and
    experts' blocks alone (deepseek-v3-671b's stacked expert leaves are
    7.5 GB a MoE layer whole, in bf16; qwen1.5-110b's stacked MLP leaves
    64 GB whole)."""
    mesh = lay.mesh
    sizes = axis_sizes(mesh)
    specs = dict(zip(_paths(opt_state), lay.opt_specs))
    step = _local(opt_state["step"])
    t = step + 1
    beta2 = adafactor_beta2(t)
    for path, d, p, g, vr, vc, ps, c in zip(
            lay.paths, lay.param_defs, tree_flatten(params), shards,
            tree_flatten(opt_state["vr"]), tree_flatten(opt_state["vc"]), lay.param_specs,
            lay.compute_specs):
        rs, cs = specs[("vr",) + path], specs[("vc",) + path]
        work = adafactor_specs(d.shape, ps, c, sizes)
        blocks = [(_local(x), sp, w) for x, sp, w in ((p, ps, work[0]), (vr, rs, work[1]),
                                                    (vc, cs, work[2]))]
        pw, vrw, vcw = [layout.relayout(x, mesh, sp, w) for x, sp, w in blocks]
        axes = _split_axes(work[0])
        total = None if not axes else (lambda x, a=axes: C.all_reduce(x, mesh, a))
        adafactor_leaf(pw, layout.relayout(g, mesh, ps, work[0]), vrw, vcw, beta2, lr,
                       total_sq=total, numel=math.prod(d.shape))
        for (x, sp, w), y in zip(blocks, (pw, vrw, vcw)):
            if y is not x:
                x.copy_(layout.relayout(y, mesh, w, sp))
        del pw, vrw, vcw
    step.copy_(t)


def _loss_sums(batch: int, seq: int, cfg: ArchConfig) -> list:
    """The vocab-parallel loss's sums over ``seq`` positions: the
    log-sum-exp's and the label logit's (f32, one a logits chunk) and the
    maximum's."""
    c = cfg.logits_chunk
    chunks = seq // c if c and seq % c == 0 and seq > c else 1
    return [("loss", 2 * 4 * batch * (seq // chunks), chunks, False),
            ("max", 4 * batch * (seq // chunks), chunks, False)]


def tp_collectives(lay: MeshLayout, batch: int, seq: int, act, dtype=None) -> list:
    """The sums over "model" one forward of ``batch`` x ``seq`` tokens sends
    in ``lay``'s compute layout, as [(what, operand bytes, count, again)],
    each an all-reduce, all but "max" sent again by the backward: "layer"
    for a layer's sum after a row-parallel product (``act`` the
    activations' dtype: attention's wo, the MLP's down projection, MLA's wo,
    the shared experts', Mamba2's wo), "norm" for Mamba2's norm's sum of
    squares over d_inner (f32), "shared" for hybrid's shared block (its
    attention's and its MLP's, once an application), "encoder" for
    whisper's encoder layers (over its ``encoder_seq`` frames), "mtp" for
    deepseek's MTP head (its embedding, block and nothing else, over
    ``seq`` - 1 positions), "embed" for the embedding's, "loss" and "max"
    for the vocab-parallel loss's (``_loss_sums``, the MTP loss's too).
    ``again``: whether a rematerialised forward sends it once more.  Under
    remat a layer's (and the shared block's) forward runs again in the
    backward, but torch's checkpoint stops that recompute once the tensors
    the backward saved are back (its early stop): a sum after the last
    product that saves its inputs is not sent again (a dense MLP's, a
    Mamba2 block's wo sum: the last thing its layer does; not the shared
    block's MLP, which w_out follows, nor the shared experts', which the
    aux loss's mean follows).  The MTP head is not rematerialised."""
    cfg, mesh = lay.cfg, lay.mesh
    if axis_sizes(mesh).get(MODEL, 1) == 1:
        return []
    rows = {"enc_blocks": cfg.encoder_seq, "mtp": seq - 1}  # positions, where not ``seq``
    what_of = {"enc_blocks": "encoder", "shared": "shared", "mtp": "mtp"}
    mtp = any(p[0] == "mtp" for p in lay.paths)
    out = []
    for path, d, c in zip(lay.paths, lay.param_defs, lay.compute_specs):
        if MODEL not in c or _is_expert(path):
            continue
        s = rows.get(path[0], seq)
        count = d.shape[0] if d.logical[0] == "layers" else 1
        if path[0] == "shared":  # one weight set, applied once a segment
            count = len(range(0, cfg.num_layers, cfg.attn_every))
        if path[-1] in ("wo", "wd"):
            last = path[-2] in ("mlp", "mamba") and path[0] != "shared"
            out.append((what_of.get(path[0], "layer"), batch * s * cfg.d_model * act.itemsize,
                        count, not last and path[0] != "mtp"))
            if path[-2] == "mamba":
                out.append(("norm", 4 * batch * s, count, True))
        elif path == ("embed", "tokens"):
            nbytes = batch * cfg.d_model * (dtype or d.dtype).itemsize
            out.append(("embed", nbytes * seq, 1, False))
            if mtp:
                out.append(("mtp", nbytes * (seq - 1), 1, False))
        if path == ("embed", "unembed") or (path == ("embed", "tokens") and cfg.tie_embeddings):
            out += _loss_sums(batch, seq, cfg)
            if mtp:
                out += _loss_sums(batch, seq - 1, cfg)
    return out


def step_collectives(cfg: ArchConfig, mesh, rules: ShardingRules, global_batch: int,
                     seq: int, *, accum: int = 1, compressed: bool = False,
                     dtype=None) -> C.CollectiveStats:
    """What one ``make_mesh_step`` step sends from each rank, counted from
    the layouts and shapes: the weight gathers to the compute layout, the
    tensor-parallel sums (``tp_collectives``: forward, backward, and a
    layer's recomputed forward under remat, each microbatch), the sharded
    MoE layers (the same passes),
    the metrics' means, the gradients' sums and means, the relayout back to
    the shards, the norm, and Adafactor's moves to its layouts and back
    with its clip's sums (``adafactor_specs``).  ``dtype``: the params'
    and the activations' dtype where it is not the ParamDefs' and the
    config's (a state cast to f32)."""
    lay = MeshLayout(cfg, mesh, rules, global_batch, seq, accum)
    stats = C.CollectiveStats()
    sizes = axis_sizes(mesh)
    if math.prod(sizes.values()) == 1:
        return stats
    pdt = lambda d: dtype or d.dtype  # noqa: E731
    for d, s, c in zip(lay.param_defs, lay.param_specs, lay.compute_specs):
        layout.relayout_sends(d.shape, pdt(d), mesh, s, c, stats)
    mb = lay.local_batch // accum
    act = dtype or cfg.dtype
    remat = cfg.remat != "none"
    for what, nbytes, count, again in tp_collectives(lay, mb, seq, act, dtype):
        # the forward; the backward, but for the max; a layer's forward again under remat
        times = 1 + (what != "max") + (remat and again)
        stats.add("all-reduce", nbytes, count * accum * times)
    moe_layers = cfg.num_layers - cfg.first_k_dense if cfg.moe is not None else 0
    if moe_layers:
        passes = moe.moe_collectives(cfg, mesh, mb, seq, act, backward=True)
        fwd = moe.moe_collectives(cfg, mesh, mb, seq, act)
        times = moe_layers * accum
        stats.merge(passes, times)
        stats.merge(fwd, times if remat else 0)
    n_metrics = 3 + (1 if cfg.mtp else 0)
    live = [a for a in sizes if sizes[a] > 1]
    for _ in live:
        stats.add("all-reduce", 4 * n_metrics)
    for d, s, c in zip(lay.param_defs, lay.param_specs, lay.compute_specs):
        block = [dim // math.prod(sizes[a] for a in entry_axes(e)) for dim, e in zip(d.shape, c)]
        gdt = torch.float32 if accum > 1 else pdt(d)  # microbatches sum into f32
        ops, now, dp = _grad_plan(c, s, sizes, lay.dp, compressed)
        for a, dim in ops:
            if sizes[a] > 1:
                stats.add("all-reduce" if dim is None else "reduce-scatter",
                          gdt.itemsize * math.prod(block))
            if dim is not None:
                block[dim] //= sizes[a]
        scales = 1
        for a in dp:
            if sizes[a] > 1:  # int8 payload and f32 scales, axis by axis
                stats.add("all-gather", math.prod(block) * scales)
                stats.add("all-gather", 4 * scales)
                scales *= sizes[a]
        layout.relayout_sends(d.shape, gdt, mesh, now, s, stats)
    for _ in live:
        stats.add("all-reduce", 4)  # the norm's sum of squares
    if cfg.optimizer != "adamw":
        odefs = dict(zip(lay.opt_paths, zip(lay.opt_defs, lay.opt_specs)))
        for path, d, s, c in zip(lay.paths, lay.param_defs, lay.param_specs,
                                 lay.compute_specs):
            work = adafactor_specs(d.shape, s, c, sizes)
            for _ in range(2):  # the params and the clipped gradient, in the params' dtype
                layout.relayout_sends(d.shape, pdt(d), mesh, s, work[0], stats)
            moments = [odefs[(key,) + path] for key in ("vr", "vc")]
            for (od, os_), w in zip(moments, work[1:]):
                layout.relayout_sends(od.shape, od.dtype, mesh, os_, w, stats)
            for a in _split_axes(work[0]):
                if sizes[a] > 1:
                    stats.add("all-reduce", 4)  # the clip's sum of squares
            # the rank's blocks back to their storage layouts
            layout.relayout_sends(d.shape, pdt(d), mesh, work[0], s, stats)
            for (od, os_), w in zip(moments, work[1:]):
                layout.relayout_sends(od.shape, od.dtype, mesh, w, os_, stats)
    return stats


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    accum: int = 1
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    peak_lr: float = 3e-3
    warmup_steps: int = 20
    seed: int = 0
    grad_compress: bool = False  # on a mesh: the int8 gradient all-reduce over the DP axes


class Trainer:
    """End to end: data → step → metrics/checkpoints/fault handling,
    on ``device`` (``None`` means the card), or on every rank of ``mesh``
    (a ``DeviceMesh``; the rank's device is the mesh's, and the state is
    laid out by ``active_rules()``: the rules of the ``activate_mesh``
    the Trainer is built under, e.g. the TP rules with fsdp to shard the
    optimizer state over "data" too, else the reference's TP rules, its
    Trainer's ``activate_mesh`` default).  The parameters are
    drawn from a generator on that device seeded with ``tc.seed``; on a
    mesh every rank draws them leaf by leaf and keeps its block of each
    (``_init_params``' ``keep``), the same numbers as the whole draw's."""

    def __init__(self, cfg: ArchConfig, ds: SyntheticLM, tc: TrainerConfig, device=None,
                 mesh=None):
        self.cfg, self.ds, self.tc = cfg, ds, tc
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's {mesh.device_type}")
            device = (torch.device("cuda", torch.cuda.current_device())
                      if mesh.device_type == "cuda" else mesh.device_type)
        self.device = resolve_device(device)
        self.schedule = Schedule(
            peak_lr=tc.peak_lr, warmup_steps=tc.warmup_steps, total_steps=tc.num_steps
        )
        self.ckpt = CheckpointManager(tc.checkpoint_dir, keep=tc.keep)
        self.detector = StragglerDetector()
        self.metrics_log: list[dict] = []
        if mesh is None:
            self.layout = None
            self.step_fn = make_train_step(cfg, self.schedule, accum=tc.accum)
        else:
            self.layout = MeshLayout(cfg, mesh, active_rules(), ds.host_batch, ds.seq_len,
                                     tc.accum)
            self.step_fn = make_mesh_step(cfg, self.layout, self.schedule,
                                          compressed=tc.grad_compress)
        self.params, self.opt_state = self._init_state()
        self._failure_at: int | None = None  # test hook: inject WorkerFailure

    def _init_params(self, keep):
        """The seeded parameters, each leaf passed through ``keep``
        (``init_model``'s) where it is given."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        return init_model(self.cfg, gen, self.device, keep=keep)

    def _init_state(self):
        """The whole state (one device), or DTensors of this rank's blocks
        (a mesh), no leaf whole but the one being drawn."""
        if self.layout is None:
            params = self._init_params(None)
            return params, init_opt_state(self.cfg.optimizer, param_defs(self.cfg), params)
        return mesh_state(self.layout, self._init_params(self.layout.keep()))

    def batch(self, step: int) -> dict:
        """The step's batch: ``make_batch``'s, or on a mesh this rank's slice."""
        batch = make_batch(self.cfg, self.ds, step, device=self.device)
        return batch if self.layout is None else self.layout.batch_slice(batch)

    def _straggling(self, dt: float) -> bool:
        """The detector's verdict; on a mesh every rank's, so that all of them
        snapshot together (a snapshot gathers)."""
        slow = self.detector.observe(dt)
        if self.mesh is None:
            return slow
        flag = torch.full((), float(slow), dtype=torch.float32, device=self.device)
        return bool(C.all_reduce(flag, self.mesh, tuple(axis_sizes(self.mesh))) > 0)

    # -- one step -------------------------------------------------------------
    def _do_step(self, step: int):
        if self._failure_at is not None and step == self._failure_at:
            self._failure_at = None  # fail once
            raise WorkerFailure(f"injected failure at step {step}")
        batch = self.batch(step)
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch, step)
        if self.device.type == "cuda":  # the step's time is the card's, not its enqueue
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if self._straggling(dt):
            self.detector.reset()  # mitigation: snapshot now, keep going
            self.ckpt.save(step, self._state(), metadata={"straggler": True})
        if step % self.tc.log_every == 0 or step == self.tc.num_steps - 1:
            row = {k: float(v) for k, v in metrics.items()} | {"step": step, "time_s": dt}
            self.metrics_log.append(row)
        if step > 0 and step % self.tc.checkpoint_every == 0:
            self.ckpt.save(step, self._state(), metadata={"loss": float(metrics["loss"])})

    def _state(self):
        return {"params": self.params, "opt_state": self.opt_state}

    def _restore(self) -> int:
        """Back to the latest committed checkpoint, in place on one device
        (every tensor keeps its storage), or to the seeded init when there
        is none.
        Waits for a save in flight first, which the reference does not:
        its restore then finds the previous checkpoint, or none."""
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            # no checkpoint yet: restart from scratch (deterministic init)
            self.params = self.opt_state = None  # one state on the device at a time
            self.params, self.opt_state = self._init_state()
            return 0
        if self.layout is None:
            step, state, _ = self.ckpt.restore(like=self._state(), device="cpu")
            for dst, src in zip(tree_flatten(self._state()), tree_flatten(state)):
                dst.copy_(src)
            return step + 1  # resume after the checkpointed step
        # on a mesh the restored shards replace the state: one state on the device at a time
        like = tree_map(lambda t: None, self._state())  # the structure alone
        self.params = self.opt_state = None
        specs = self.layout.opt_specs + self.layout.param_specs  # the state's leaf order
        step, state, _ = self.ckpt.restore(
            like=like, sharding_fn=lambda i, a: (self.mesh, spec_placements(specs[i], self.mesh)))
        self.params, self.opt_state = state["params"], state["opt_state"]
        return step + 1

    # -- loop -------------------------------------------------------------------
    def run(self, start_step: int = 0) -> dict:
        stats = run_with_restarts(
            self._do_step,
            start_step=start_step,
            num_steps=self.tc.num_steps - start_step,
            restore_fn=self._restore,
            sleep=lambda s: None,
        )
        self.ckpt.save(self.tc.num_steps - 1, self._state(), blocking=True,
                       metadata={"final": True})
        return stats | {"metrics": self.metrics_log}
