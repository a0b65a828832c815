"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's arithmetic: for every cell of ``iter_cells`` on both production
meshes, the resident bytes a device, the model FLOPs and fits-in-HBM (the
reference's resident bytes against ``H100Chip``'s 80 GB) equal what the
reference computes from its abstract inputs in a subprocess with 512 forced
host devices, without compiling (``tests/jax_reference_runs.py rules``).
That is ``cell_arithmetic``, which traces nothing: its traced fields are
``null``.  The CLI traces (``run_cell``): one full-size cell,
granite-3-8b x train_4k on 16 x 16, its traced fields filled, its
collectives as counted; the fields no trace gives stay ``null``.  A decode
cell (whisper-tiny x decode_32k on 16 x 16, its cache split over "model"
on its positions) fills every traced field too.  The traced half itself:
``tests/test_torch_dryrun_trace.py``."""
import json

import pytest

from repro_torch.core.energy import DEFAULT_CHIP
from repro_torch.launch import dryrun

from test_torch_sharding_rules import reference_run

NULL_FIELDS = ("compile_s", "hlo_bytes")  # no compile and no HLO: null in every cell
TRACE_S = 60  # granite-3-8b x train_4k's full-depth trace on the CPU


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "rules.json")
    reference_run("rules", out, 512)
    with open(out) as f:
        return json.load(f)


def test_the_cells_are_the_reference_cells(ref):
    assert [list(c) for c in dryrun.iter_cells()] == ref["iter_cells"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch, shape_id", list(dryrun.iter_cells()))
def test_cell_arithmetic_matches_the_reference(ref, arch, shape_id, multi_pod):
    got = dryrun.cell_arithmetic(arch, shape_id, multi_pod=multi_pod)
    mesh = "2x16x16" if multi_pod else "16x16"
    assert got["mesh"] == mesh and got["chips"] == (512 if multi_pod else 256)
    assert got["fsdp"] == ref["fsdp"][arch]
    resident = ref["cells"][arch][shape_id][mesh]["tp_fsdp" if got["fsdp"] else "tp"]["resident"]
    assert got["resident_bytes_per_dev"] == resident
    assert got["fits_hbm_resident"] == (resident <= DEFAULT_CHIP.hbm_bytes)
    assert got["model_flops"] == pytest.approx(ref["model_flops"][arch][shape_id], rel=1e-12)
    for field in NULL_FIELDS + dryrun.TRACED_FIELDS:
        assert got[field] is None, field
    assert got["collectives"]["hlo"] is None and got["collectives"]["traced"] is None
    assert got["collectives"]["analytic"]["total_bytes"] > 0


def test_main_returns_zero_and_writes_the_cell(tmp_path, capsys):
    """The CLI at full size: granite-3-8b x train_4k on 16 x 16, the rank's
    step traced in under ``TRACE_S``; it fits the card live, sends what the
    analytic count says, and the depth fit agrees with the full depth."""
    assert dryrun.main(["--arch", "granite-3-8b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    with open(tmp_path / "16x16__granite-3-8b__train_4k.json") as f:
        cell = json.load(f)
    assert cell["fits_hbm_resident"] and cell["fits_hbm_live"]
    assert 0 < cell["lower_s"] < TRACE_S
    assert cell["resident_bytes_per_dev"] < cell["live_bytes_per_dev"] <= DEFAULT_CHIP.hbm_bytes
    assert cell["live_gb_per_dev"] == round(cell["live_bytes_per_dev"] / 1024**3, 3)
    assert cell["memory_analysis"].startswith("peak ") and len(cell["memory_analysis"]) <= 2000
    coll = cell["collectives"]
    assert coll["traced"] == coll["analytic"] and coll["hlo"] is None
    ca = cell["cost_analysis"]
    assert ca["fit"]["flops_per_dev"] == pytest.approx(ca["flops_per_dev"], rel=1e-9)
    assert ca["bytes_per_dev"] == cell["mem_terms"]["total"]
    for field in NULL_FIELDS:
        assert cell[field] is None, field
    assert "granite-3-8b × train_4k" in capsys.readouterr().out
    assert dryrun.main(["--table", "--out", str(tmp_path)]) == 0
    row = capsys.readouterr().out.splitlines()[-1]
    assert row.startswith("| granite-3-8b | train_4k | ") and row.count("|") == 10


def test_a_decode_cell_fills_every_traced_field():
    """whisper-tiny x decode_32k on 16 x 16 at full size: ``trace_cell``
    fills every ``TRACED_FIELDS`` entry; the step holds at least the
    cell's resident bytes (its params and its block of the cache) live,
    sends what the analytic count says, and the depth fit agrees with the
    full depth."""
    cell = dryrun.trace_cell(dryrun.cell_arithmetic("whisper-tiny", "decode_32k"))
    assert cell["kind"] == "decode"
    for field in dryrun.TRACED_FIELDS:
        assert cell[field] is not None, field
    for field in NULL_FIELDS:
        assert cell[field] is None, field
    assert cell["resident_bytes_per_dev"] <= cell["live_bytes_per_dev"] <= DEFAULT_CHIP.hbm_bytes
    coll = cell["collectives"]
    assert coll["traced"] == coll["analytic"] and coll["hlo"] is None
    ca = cell["cost_analysis"]
    assert ca["flops_per_dev"] > 0
    assert ca["fit"]["flops_per_dev"] == pytest.approx(ca["flops_per_dev"], rel=1e-9)


def test_overrides_parse_as_the_reference_does():
    assert dryrun._parse_override("remat=none") == ("remat", "none")
    assert dryrun._parse_override("attn_chunk=512") == ("attn_chunk", 512)
    assert dryrun._parse_override("scan_layers=False") == ("scan_layers", False)
    cfg = dryrun.apply_overrides(dryrun.get_config("granite-3-8b"), {"kv_dtype": "float32"})
    assert str(cfg.kv_dtype) == "torch.float32"


def test_train_cell_counts_the_tensor_parallel_step():
    """granite-3-8b x train_4k on 16 x 16 (no fsdp at 8 B params): the cell's
    collectives are ``step_collectives``', and with every TP leaf computed
    on its "model" block nothing is gathered; the activation sums (16 x
    4096 tokens x 4096 x bf16 each: attention's and the MLP's forward and
    backward, attention's again under remat, over 40 layers) are 200 of
    the all-reduces."""
    from repro_torch.configs import get_config
    from repro_torch.sharding.rules import make_rules
    from repro_torch.training.train_loop import step_collectives

    got = dryrun.cell_arithmetic("granite-3-8b", "train_4k")["collectives"]["analytic"]
    cfg = get_config("granite-3-8b")
    want = step_collectives(cfg, dryrun.production_mesh_shape(), make_rules("tp"), 256, 4096)
    assert got == want.summary() and "all-gather" not in got["by_op"]
    sums = 200 * 16 * 4096 * cfg.d_model * 2
    assert got["by_op"]["all-reduce"]["operand_bytes"] > sums
