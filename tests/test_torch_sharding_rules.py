"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's.

The first six tests are the twins of ``tests/test_sharding_rules.py``'s
(a stub mesh: only its shape is read); the reference's seventh,
``test_constrain_is_identity_without_mesh``, has none, because ``constrain``
is not ported.  Then parity over every arch: each parameter and
optimizer-state leaf on (16, 16) and (2, 16, 16) under the three rule sets
(tp, tp with fsdp, fsdp_only), and each arch × shape cell's input and cache
leaves and resident bytes, against the reference run once in a subprocess
with 512 forced host devices (``tests/jax_reference_runs.py rules``; nothing
is compiled), shared by a module-scoped fixture."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
from repro_torch.launch.dryrun import cell_inputs, production_mesh_shape
from repro_torch.launch.dryrun import resident_bytes_per_device
from repro_torch.models.model import param_defs
from repro_torch.models.params import ParamDef, abstract_params, tree_flatten
from repro_torch.sharding.rules import (
    MeshShape,
    ShardingRules,
    activate_mesh,
    batch_axes,
    batch_spec,
    make_rules,
    placements_for,
    spec_for,
    tensor_parallel_rules,
)
from repro_torch.training.optimizer import opt_state_defs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = MeshShape({"data": 16, "model": 16})
MULTI = MeshShape({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": SINGLE, "2x16x16": MULTI}
RULESETS = {"tp": ("tp", False), "tp_fsdp": ("tp", True), "fsdp_only": ("fsdp_only", False)}


def reference_run(mode: str, out: str, devices: int, *args: str) -> None:
    """``tests/jax_reference_runs.py`` in a subprocess on forced host devices."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "jax_reference_runs.py"),
                           mode, *args, out], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rules") / "rules.json")
    reference_run("rules", out, 512)
    with open(out) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# twins of tests/test_sharding_rules.py
# ---------------------------------------------------------------------------
def test_tp_axes_shard_when_divisible():
    rules = tensor_parallel_rules()
    d = ParamDef((4096, 32, 128), ("embed", "heads", None))
    assert spec_for(d, SINGLE, rules) == (None, "model", None)
    d_ff = ParamDef((4096, 12800), ("embed", "mlp"))
    assert spec_for(d_ff, SINGLE, rules) == (None, "model")


def test_indivisible_dims_fall_back_to_replication():
    rules = tensor_parallel_rules()
    d = ParamDef((6144, 1, 128), ("embed", "kv_heads", None))
    assert spec_for(d, SINGLE, rules) == (None, None, None)
    d = ParamDef((384, 6, 64), ("embed", "heads", None))
    assert spec_for(d, SINGLE, rules) == (None, None, None)


def test_fsdp_shards_embed_axis_over_data():
    no = tensor_parallel_rules(fsdp=False)
    yes = tensor_parallel_rules(fsdp=True)
    d = ParamDef((8192, 64, 128), ("embed", "heads", None))
    assert spec_for(d, SINGLE, no) == (None, "model", None)
    assert spec_for(d, SINGLE, yes) == ("data", "model", None)
    # as DTensor placements, one a mesh dim: data splits dim 0, model dim 1
    assert placements_for(d, SINGLE, yes) == [Shard(0), Shard(1)]
    assert placements_for(d, SINGLE, no) == [Replicate(), Shard(1)]


def test_axis_used_only_once_per_tensor():
    rules = tensor_parallel_rules()
    d = ParamDef((51200, 12800), ("vocab", "mlp"))
    assert spec_for(d, SINGLE, rules) == ("model", None)


def test_stacked_layer_dim_never_sharded():
    rules = tensor_parallel_rules()
    d = ParamDef((40, 4096, 12800), ("layers", "embed", "mlp"))
    assert spec_for(d, SINGLE, rules) == (None, None, "model")


def test_batch_axes_and_spec():
    assert batch_axes(SINGLE) == ("data",)
    assert batch_axes(MULTI) == ("pod", "data")
    assert batch_spec(256, SINGLE) == ("data", None)
    assert batch_spec(256, MULTI) == (("pod", "data"), None)
    assert batch_spec(1, MULTI) == (None, None)
    assert batch_spec(128, SINGLE, extra_dims=3) == ("data", None, None, None)


def test_a_dim_over_two_axes_is_sharded_on_both_in_mesh_order():
    rules = make_rules("fsdp_only")
    d = ParamDef((4096, 12800), ("embed", "mlp"))
    assert spec_for(d, MULTI, rules) == (("data", "model"), None)
    assert placements_for(d, MULTI, rules) == [Replicate(), Shard(0), Shard(0)]
    backwards = ShardingRules(rules={"embed": ("model", "data")}, fsdp=True)
    with pytest.raises(ValueError, match="mesh order"):
        placements_for(d, SINGLE, backwards)


# ---------------------------------------------------------------------------
# parity with the reference over every arch, shape, mesh and rule set
# ---------------------------------------------------------------------------
def _rows(tree, mesh) -> list:
    return [[list(l.spec) if l.spec is not None else None, list(l.shard_shape(mesh)),
             list(l.shape), str(l.dtype).replace("torch.", "")] for l in tree_flatten(tree)]


def _want(rows) -> list:
    return [[[e for e in spec], shard, shape, dtype] for _, spec, shard, shape, dtype in rows]


def _spec_json(rows):
    return [[[list(e) if isinstance(e, tuple) else e for e in r[0]], *r[1:]] for r in rows]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_optimizer_specs_match_the_reference(ref, arch, mesh_name):
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]
    defs = param_defs(cfg)
    for tree, key in ((defs, "params"), (opt_state_defs(cfg.optimizer, defs), "opt")):
        for rname, (par, fsdp) in RULESETS.items():
            rules = make_rules(par, fsdp=fsdp)
            got = _spec_json(_rows(abstract_params(tree, lambda d: spec_for(d, mesh, rules)),
                                   mesh))
            want = _want(ref[key][arch][mesh_name][rname])
            assert len(got) == len(want), (key, rname)
            for i, (g, w) in enumerate(zip(got, want)):
                assert g == w, (key, rname, ref[key][arch][mesh_name][rname][i][0])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_id", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_cell_inputs_and_resident_bytes_match_the_reference(ref, arch, shape_id, mesh_name):
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]
    for rname, (par, fsdp) in RULESETS.items():
        rules = make_rules(par, fsdp=fsdp)
        with activate_mesh(mesh, rules):
            got = _spec_json(_rows(input_specs(cfg, shape_id, mesh), mesh))
            resident = resident_bytes_per_device(cell_inputs(cfg, shape_id, mesh, rules), mesh)
        want = ref["cells"][arch][shape_id][mesh_name][rname]
        assert got == _want(want["inputs"]), rname
        assert resident == want["resident"], rname


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b"])
def test_state_shardings_place_the_abstract_state(arch):
    """``state_shardings`` and ``abstract_state`` lay each leaf out alike:
    the same spec, its placements, and ``shard_shape`` the block."""
    from repro_torch.training.train_loop import abstract_state, state_shardings

    cfg = get_config(arch)
    rules = make_rules("tp", fsdp=True)
    shardings = [l for t in state_shardings(cfg, MULTI, rules) for l in tree_flatten(t)]
    leaves = [l for t in abstract_state(cfg, MULTI, rules) for l in tree_flatten(t)]
    assert len(shardings) == len(leaves) > 0
    for sh, leaf in zip(shardings, leaves):
        assert sh.spec == leaf.spec
        assert len(sh.placements) == 3
        for p, n in zip(sh.placements, (2, 16, 16)):
            if p.is_shard():
                assert leaf.shape[p.dim] % n == 0


def test_production_mesh_shapes_are_the_reference_meshes():
    assert production_mesh_shape().shape == {"data": 16, "model": 16}
    assert production_mesh_shape(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert torch.bfloat16.itemsize == 2  # AbstractLeaf sizes come from torch's dtypes
