"""The port's record of collectives (``repro_torch.core.collectives``).

``CollectiveStats`` with the reference's operand-byte conventions, checked
with the canned counts of ``tests/test_hlo_analysis.py`` where they mean
something without HLO (the while-loop trip counts are the port's loop run
ten times; collective-permute has no counterpart in the port), and the
choke point itself on a spawned world of 4 gloo ranks: each collective's
values, its gradient (the transpose) and the bytes it records, and the
checkpoint save's gather of a whole tensor to the first ranks alone."""
import numpy as np
import pytest

from repro_torch.core.collectives import CollectiveStats, operand_bytes
from repro_torch.launch.world import run_world

import torch_dist_workers as W


def test_trip_count_scaling():
    stats = CollectiveStats()
    for _ in range(10):  # the body: an all-gather and an all-reduce of f32[64,512] over 4
        stats.add("all-gather", operand_bytes("all-gather", 64 * 512 * 4, 4))
        stats.add("all-reduce", operand_bytes("all-reduce", 64 * 512 * 4, 4))
    stats.add("reduce-scatter", operand_bytes("reduce-scatter", 16 * 512 * 4, 4))
    assert stats.operand_bytes["all-gather"] == 32768 * 10
    assert stats.counts["all-gather"] == 10
    assert stats.operand_bytes["all-reduce"] == 131072 * 10
    assert stats.operand_bytes["reduce-scatter"] == 131072
    assert stats.total_bytes == 32768 * 10 + 131072 * 11


def test_async_start_done_counted_once():
    stats = CollectiveStats()
    stats.add("all-reduce", operand_bytes("all-reduce", 8 * 8 * 4, 2))
    assert stats.counts["all-reduce"] == 1
    assert stats.operand_bytes["all-reduce"] == 8 * 8 * 4


def test_bf16_and_explicit_groups():
    assert operand_bytes("all-gather", 512 * 2, 4) == 256


def test_merge_keeps_the_bytes_of_collectives_of_unequal_sizes():
    """A MoE layer's forward sends one all-reduce of its tokens and two of
    its f32 aux loss: 32 layers of it are 96 all-reduces of those bytes,
    not 96 of their mean rounded down."""
    layer = CollectiveStats()
    layer.add("all-reduce", 24576)
    layer.add("all-reduce", 4, 2)
    total = CollectiveStats()
    total.merge(layer, 32)
    assert total.counts == {"all-reduce": 96}
    assert total.operand_bytes == {"all-reduce": 32 * (24576 + 8)}


def test_no_collectives():
    stats = CollectiveStats()
    assert stats.total_bytes == 0 and not stats.counts
    assert stats.summary() == {"total_bytes": 0, "by_op": {}}
    with pytest.raises(ValueError):
        stats.add("collective-permute", 8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("collectives")
    return run_world(W.collectives_main, 4, backend="gloo", init_file=str(root / "store"),
                     timeout_s=120)


def test_collectives_values_and_gradients(world):
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)  # rank r's block: x * (r + 1)
    full = np.concatenate([x * (r + 1) for r in range(4)])
    for rank, got in enumerate(world):
        np.testing.assert_array_equal(got["all_gather"], full)
        np.testing.assert_array_equal(got["all_reduce"], x * 10)
        # all-to-all: block j of each rank's rows goes to rank j, sources stacked along dim 1
        want = np.concatenate([(x * (s + 1))[rank:rank + 1] for s in range(4)], axis=1)
        np.testing.assert_array_equal(got["all_to_all"], want)
        # d/dx of sum(w * op(x)), every rank's loss summed: the transposes
        np.testing.assert_array_equal(got["grad_all_gather"], np.full_like(x, 4))
        np.testing.assert_array_equal(got["grad_all_reduce"], np.full_like(x, 4))
        np.testing.assert_array_equal(got["grad_all_to_all"], np.ones_like(x))


def test_recorded_bytes_follow_the_conventions(world):
    for got in world:
        rec = got["recorded"]["by_op"]
        block = 4 * 6 * 4  # f32 (4, 6)
        assert rec["all-gather"] == {"count": 1, "operand_bytes": block}
        assert rec["all-reduce"] == {"count": 2, "operand_bytes": 2 * block}
        # the all-gather's backward (its operand: the 4 ranks' blocks)
        assert rec["reduce-scatter"] == {"count": 1, "operand_bytes": 4 * block}
        assert rec["all-to-all"] == {"count": 2, "operand_bytes": 2 * block}
        assert "staged" not in got["recorded"]  # CPU tensors are never staged


@pytest.mark.parametrize("spec, holders, second", [
    (("data", "model"), {0}, "data"), ((("data", "model"), None), {0}, "model"),
    (("data", None), {0, 1}, None)])
def test_full_on_first_gathers_to_the_first_ranks_alone(world, spec, holders, second):
    """``layout.full_on_first``: the whole tensor on the ranks at coordinate
    0 of every axis that splits it (rank 0 among them, and each replica of
    it on an axis that does not split it), ``None`` elsewhere; each gather
    recorded with its operand, the rank's block or what it has gathered.
    ``second``: the axis whose coordinate-0 ranks make the second gather
    (the first gather's axis; a dim split over two axes gathers the inner
    one first)."""
    whole = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    block = whole.nbytes // (2 if second is None else 4)
    for rank, got in enumerate(world):
        value, rec = got[f"first/{spec}"]
        if rank in holders:
            np.testing.assert_array_equal(value, whole)
        else:
            assert value is None
        coord = dict(zip(("data", "model"), divmod(rank, 2)))
        sends = [block] + ([2 * block] if second and coord[second] == 0 else [])
        assert rec["by_op"] == {"gather": {"count": len(sends), "operand_bytes": sum(sends)}}
