"""The port's block-size tuner (``repro_torch.kernels.autotune``), case for
case beside ``tests/test_autotune.py``, against the ``H100Chip``:
feasibility by shared memory, the disk cache's distrust, int8 widening the
tile, distinct dtype keys, stack against sequential traffic, measured
refinement through ``bench.make_measure_fn`` (on the CPU, the plain
versions), determinism and cache, top-k refinement, unknown kernels, and the
``"auto"`` outputs against the oracles.  Then what the port adds: the
analytic picks at the main path's shapes are the plans of the fixed rules
the tuner replaced, the LSTM
kernels are scored against the f32 peak, a wrapper reaches the tuner once a
shape, and no shape is tuned inside a CUDA graph capture."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.cost_model import chip_for_dtype
from repro_torch.core.energy import DEFAULT_CHIP
from repro_torch.kernels import autotune as at
from repro_torch.kernels import bench, ops
from repro_torch.kernels import int8_matmul as k5
from repro_torch.kernels import lstm_cell as k2
from repro_torch.kernels import lstm_seq as k3
from repro_torch.kernels import ref as tref
from repro_torch.kernels import runtime

torch.set_num_threads(1)

PROBLEM = {"m": 256, "k": 4096, "n": 12800}  # a prefill's wg/wu projection
WIDE = {"batch": 200, "seq": 28, "d_in": 256, "hidden": 256}  # K3 where f32 and int8 differ


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Each test gets a fresh in-process and on-disk cache, and fresh
    memoized plans."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    at.clear_cache()
    for fn in (k3.plan_launch, k2.plan, k5.plan):
        fn.cache_clear()
    yield
    at.clear_cache()
    for fn in (k3.plan_launch, k2.plan, k5.plan):
        fn.cache_clear()


# ---------------------------------------------------------------------------
# Feasibility pruning
# ---------------------------------------------------------------------------
def test_feasible_candidates_fit_smem():
    tiny = dataclasses.replace(DEFAULT_CHIP, smem_per_block=64 * 1024)
    cands = at.feasible_candidates("int8_matmul", PROBLEM, tiny, dtype="int8")
    assert cands and len(cands) < len(at.feasible_candidates("int8_matmul", PROBLEM,
                                                             dtype="int8"))
    for c in cands:
        assert at.vmem_footprint_bytes("int8_matmul", PROBLEM, c) <= tiny.smem_per_block


def test_tuned_choice_respects_smem_budget():
    """Distinct chips get distinct cache keys — a winner tuned for the big
    budget must never be served for the small one."""
    tiny = dataclasses.replace(DEFAULT_CHIP, smem_per_block=64 * 1024)
    big = at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu")  # caches first
    best = at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu", chip=tiny)
    assert at.vmem_footprint_bytes("int8_matmul", PROBLEM, best) <= tiny.smem_per_block
    assert (big["block_m"], best["block_m"]) == (128, 64)  # 128 x 128 needs 73,728 bytes
    t_big = at.predict_time_s("int8_matmul", PROBLEM, big, dtype="int8")
    t_tiny = at.predict_time_s("int8_matmul", PROBLEM, best, dtype="int8")
    assert t_big <= t_tiny
    assert at.cache_key("int8_matmul", PROBLEM, "int8", "cpu") != at.cache_key(
        "int8_matmul", PROBLEM, "int8", "cpu", chip=tiny)


@pytest.mark.parametrize("entry", [{"block_m": "rm -rf", "block_n": -1},
                                   {"block_m": 16, "block_n": 64, "block_k": True},
                                   {"block_m": 16, "block_n": 64, "block_k": 64, "block_b": 1},
                                   {"block_b": 4}])
def test_poisoned_disk_entry_rejected(entry):
    """Disk cache is untrusted: an entry that is not the kernel's own
    candidate fields as positive ints is re-tuned, not served."""
    key = at.cache_key("int8_matmul", PROBLEM, "int8", "cpu")
    with open(at._cache_path(), "w") as f:
        json.dump({"model": at.MODEL, "entries": {key: entry}}, f)
    best = at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu")
    assert set(best) == {"block_m", "block_n", "block_k"}
    assert all(isinstance(v, int) and v > 0 for v in best.values())
    assert best != entry


def test_disk_file_of_another_model_is_ignored():
    key = at.cache_key("int8_matmul", PROBLEM, "int8", "cpu")
    planted = {"block_m": 64, "block_n": 128, "block_k": 64}
    with open(at._cache_path(), "w") as f:
        json.dump({"model": "another", "entries": {key: planted}}, f)
    assert at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu") != planted


@pytest.mark.parametrize("prob", [{"m": 96, "k": 160, "n": 224}, {"m": 33, "k": 7, "n": 65}])
def test_chunks_cover_k_for_ragged_matmul(prob):
    """The port's K5 masks ragged edges (the reference asks its tiles to
    divide the dims): a built tile, and chunks of K that cover it exactly."""
    best = at.autotune("int8_matmul", prob, dtype="int8", backend="cpu")
    p = k5.plan_for(prob["m"], prob["k"], prob["n"], best["block_m"], best["block_n"],
                    best["block_k"])
    assert (p.block_m, p.block_n) in k5.TILES and p.block_m > k5.SMALL_M
    assert (p.split_k - 1) * p.k_chunk < prob["k"] <= p.split_k * p.k_chunk


def test_lstm_stack_long_sequence_narrows_batch_tile():
    """Shared-memory feasibility shrinks the batch tile once the stack's
    inter-layer sequence (S·bb·H·4 bytes on the block path) outgrows a block."""
    prob = {"batch": 512, "seq": 512, "d_in": 32, "hidden": 36, "layers": 2}  # no cluster split
    widest = max(c["block_b"] for c in at.feasible_candidates("lstm_stack", prob))
    best = at.autotune("lstm_stack", prob, backend="cpu")
    assert at.vmem_footprint_bytes("lstm_stack", prob, best) <= DEFAULT_CHIP.smem_per_block
    assert best["block_b"] <= widest < 512
    # a short sequence at the same budget affords a wider batch tile
    short = {**prob, "seq": 16}
    assert max(c["block_b"] for c in at.feasible_candidates("lstm_stack", short)) > widest


# ---------------------------------------------------------------------------
# dtype-aware footprints (int8 residency) + the lstm_stack traffic model
# ---------------------------------------------------------------------------
def test_int8_weights_shrink_footprint_and_widen_tile():
    """int8 slices of u take a quarter of f32's shared memory, so at a batch
    where f32's cluster blocks are crowded the int8 tuner takes a WIDER tile."""
    cand = {"block_b": 7}
    fp = at.vmem_footprint_bytes("lstm_seq", WIDE, cand, dtype="float32")
    q8 = at.vmem_footprint_bytes("lstm_seq", WIDE, cand, dtype="int8")
    assert q8 < fp
    widest = lambda dt: max(c["block_b"] for c in at.feasible_candidates(  # noqa: E731
        "lstm_seq", WIDE, dtype=dt))
    assert widest("int8") > widest("float32")
    best_fp = at.autotune("lstm_seq", WIDE, dtype="float32", backend="cpu")
    best_q8 = at.autotune("lstm_seq", WIDE, dtype="int8", backend="cpu")
    assert best_q8["block_b"] > best_fp["block_b"], (best_fp, best_q8)


def test_dtype_cache_keys_distinct():
    """float32 and int8 never share winners: distinct cache keys,
    independently cached entries."""
    k_fp = at.cache_key("lstm_seq", WIDE, "float32", "cpu")
    k_q8 = at.cache_key("lstm_seq", WIDE, "int8", "cpu")
    assert k_fp != k_q8
    best_fp = at.autotune("lstm_seq", WIDE, dtype="float32", backend="cpu")
    best_q8 = at.autotune("lstm_seq", WIDE, dtype="int8", backend="cpu")
    assert at._CACHE[k_fp] == best_fp
    assert at._CACHE[k_q8] == best_q8
    assert best_fp != best_q8  # at this shape the winners genuinely differ


def test_lstm_stack_model_beats_sequential_traffic():
    """The fused stack's device-memory traffic undercuts L sequential
    lstm_seq calls (which bounce the inter-layer h sequence through it)."""
    prob = {"batch": 32, "seq": 28, "d_in": 128, "hidden": 128, "layers": 3}
    best = at.autotune("lstm_stack", prob, backend="cpu")
    assert at.vmem_footprint_bytes("lstm_stack", prob, best) <= DEFAULT_CHIP.smem_per_block
    seq_prob = {k: v for k, v in prob.items() if k != "layers"}
    stack = at._lstm_seq_analyze(prob, best, "float32")
    per_layer = at._lstm_seq_analyze(seq_prob, best, "float32")
    assert stack.hbm_bytes < prob["layers"] * per_layer.hbm_bytes
    # int8 weights fit one block's shared memory where f32 needs a cluster's
    assert k3.plan_for(best["block_b"], 32, 28, 128, 128, layers=3).path == "cluster"
    assert k3.plan_for(best["block_b"], 32, 28, 128, 128, layers=3,
                       quantized=True).path == "block"


@pytest.mark.parametrize("kernel,problem,dtype", [
    ("lstm_seq", {"batch": 8, "seq": 4, "d_in": 8, "hidden": 16}, "float32"),
    ("lstm_seq", {"batch": 8, "seq": 4, "d_in": 8, "hidden": 16}, "int8"),
    ("lstm_stack", {"batch": 8, "seq": 4, "d_in": 8, "hidden": 16, "layers": 2}, "float32"),
    ("lstm_cell", {"batch": 8, "d_in": 8, "hidden": 16}, "float32"),
    ("int8_matmul", {"m": 4, "k": 256, "n": 64}, "int8"),
    ("flash_attention", {"b": 1, "h": 2, "sq": 16, "sk": 16, "d": 16}, "bfloat16"),
    ("flash_attention", {"b": 1, "h": 2, "sq": 16, "sk": 16, "d": 16}, "float32"),
])
def test_measured_refinement_via_make_measure_fn(kernel, problem, dtype):
    """``bench.make_measure_fn`` re-ranks the analytic top-k by timing the
    candidates (here on the CPU: the plain versions) and the measured
    winner lands in the cache, where later analytic calls find it."""
    measure = bench.make_measure_fn(kernel, problem, dtype, device="cpu", n=1)
    head = at.ranked_candidates(kernel, problem, dtype=dtype)[:2]
    best = at.autotune(kernel, problem, dtype=dtype, backend="measured", measure_fn=measure,
                       top_k=2)
    assert best in head
    key = at.cache_key(kernel, problem, dtype, "measured")
    assert at._CACHE[key] == best
    assert at.autotune(kernel, problem, dtype=dtype, backend="measured") == best


def test_make_measure_fn_refuses_unknown_kernels():
    with pytest.raises(ValueError):
        bench.make_measure_fn("nope", {}, device="cpu")


# ---------------------------------------------------------------------------
# Determinism + cache
# ---------------------------------------------------------------------------
def test_choice_deterministic_and_cached(monkeypatch):
    c1 = at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu")
    c2 = at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu")
    assert c1 == c2
    key = at.cache_key("int8_matmul", PROBLEM, "int8", "cpu")
    assert at._CACHE[key] == c1
    disk = json.load(open(at._cache_path()))
    assert disk["model"] == at.MODEL and disk["entries"][key] == c1
    # a fresh process (cleared in-process cache) reloads the disk entry
    # without re-scoring: poison the candidate generator to prove it
    at.clear_cache()
    monkeypatch.setitem(
        at._KERNELS, "int8_matmul",
        (lambda p: (_ for _ in ()).throw(AssertionError("re-scored")),
         at._KERNELS["int8_matmul"][1]),
    )
    assert at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu") == c1


def test_distinct_keys_tune_independently():
    a = at.autotune("int8_matmul", {"m": 4, "k": 64, "n": 64}, dtype="int8", backend="cpu")
    b = at.autotune("int8_matmul", {"m": 512, "k": 512, "n": 512}, dtype="int8", backend="cpu")
    assert a["block_m"] == 16 and b["block_m"] >= 64
    k1 = at.cache_key("int8_matmul", {"m": 4, "k": 64, "n": 64}, "int8", "cpu")
    k2 = at.cache_key("int8_matmul", {"m": 512, "k": 512, "n": 512}, "int8", "cpu")
    assert k1 != k2 and k1 in at._CACHE and k2 in at._CACHE


def test_measure_fn_refines_top_k():
    calls = []

    def fake_time(cand):
        calls.append(dict(cand))
        return float(-cand["block_b"])  # pretend larger tiles are faster

    best = at.autotune(
        "lstm_seq", {"batch": 256, "seq": 16, "d_in": 8, "hidden": 16},
        dtype="float32", backend="measured", measure_fn=fake_time, top_k=3,
    )
    assert 1 < len(calls) <= 3
    assert best["block_b"] == max(c["block_b"] for c in calls)


def test_unknown_kernel_rejected():
    with pytest.raises(ValueError):
        at.autotune("nope", {"m": 1}, backend="cpu")


# ---------------------------------------------------------------------------
# "auto" through the wrappers, against the oracles
# ---------------------------------------------------------------------------
def test_int8_matmul_auto_blocks_match_ref():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = rng.standard_normal((128, 96)).astype(np.float32)
    xq, sx = jref.quantize_rowwise(jnp.asarray(x))
    wq, sw = jref.quantize_colwise(jnp.asarray(w))
    targs = [torch.from_numpy(np.array(a)) for a in (xq, wq, sx, sw)]
    got = ops.int8_matmul(*targs, block_m="auto", block_n="auto", block_k="auto")
    want = jref.int8_matmul_ref(xq, wq, sx, sw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))
    assert torch.equal(got, tref.int8_matmul_ref(*targs))


def test_flash_attention_auto_blocks_match_ref():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 4, 64, 32)).astype(np.float32) for _ in range(3))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, block_q="auto",
                              block_k="auto")
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                              causal=True).numpy(), atol=2e-5, rtol=2e-5)


def test_lstm_cell_auto_blocks_match_ref():
    rng = np.random.default_rng(2)
    x, h, c = (rng.standard_normal(s).astype(np.float32) for s in ((24, 6), (24, 20), (24, 20)))
    w = (rng.standard_normal((6, 80)) * 0.3).astype(np.float32)
    u = (rng.standard_normal((20, 80)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(80) * 0.1).astype(np.float32)
    got_h, got_c = ops.lstm_cell(*map(torch.from_numpy, (x, h, c, w, u, b)), block_b="auto")
    want_h, want_c = jref.lstm_cell_ref(*map(jnp.asarray, (x, h, c, w, u, b)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# What the port adds
# ---------------------------------------------------------------------------
H100_SLOTS = 15


@pytest.mark.parametrize("kernel,layers", [("lstm_seq", 1), ("lstm_stack", 3)])
@pytest.mark.parametrize("quantized", [False, True])
def test_analytic_pick_is_the_fixed_plan_at_the_bench_width(kernel, layers, quantized):
    """(40, 28, 256, 256), f32 and int8, one layer and the 3-layer stack: the
    cluster path, 3 rows x 14 clusters, the whole projection at once."""
    plan = k3.plan_launch("auto", 40, 28, 256, 256, layers=layers, quantized=quantized,
                          slots=H100_SLOTS)
    assert (plan.path, plan.block_b, plan.clusters, plan.chunk) == ("cluster", 3, 14, 28)


def test_analytic_pick_is_the_fixed_plan_at_the_paper_shape():
    """B = 64 at the paper's widths: the block path, one row a block; K2 two
    rows a block (32 x 3 blocks), and 10 rows at 40x256x256 (4 x 32)."""
    plan = k3.plan_launch("auto", 64, 28, 6, 20, slots=H100_SLOTS)
    assert (plan.path, plan.block_b, plan.clusters) == ("block", 1, 64)
    assert k2.plan("auto", 64, 6, 20).rows == 2
    assert k2.plan("auto", 40, 256, 256).grid == (4, 32)


@pytest.mark.parametrize("k,n", [(4096, 12800), (4096, 4096), (12800, 4096)])
def test_analytic_pick_at_decode_fills_the_card(k, n):
    """K5 at M = 4: 16 x 128 tiles, K split until the grid has 2 x 132
    blocks (the least split that does: more only adds partial sums)."""
    p = k5.plan(4, k, n)
    assert (p.block_m, p.block_n) == (16, 128)
    assert p.blocks(4, n) >= 2 * runtime.SM_COUNT
    if p.split_k > 1:  # one chunk fewer leaves the grid short of 2 x 132
        steps = -(-k // k5.BLOCK_K)
        fewer = k5.plan_for(4, k, n, 16, 128, -(-steps // (p.split_k - 1)) * k5.BLOCK_K)
        assert fewer.blocks(4, n) < 2 * runtime.SM_COUNT


@pytest.mark.parametrize("kernel,problem", [
    ("lstm_seq", {"batch": 5000, "seq": 28, "d_in": 6, "hidden": 20}),
    ("lstm_cell", {"batch": 5000, "d_in": 6, "hidden": 20}),
])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_lstm_kernels_are_scored_against_the_f32_peak(kernel, problem, dtype):
    """K2-K4 run IEEE f32 multiply-adds on the CUDA cores (int8 weights are
    widened to f32): their model moves with the f32 peak and not with the
    tensor cores' bf16 or int8 peaks."""
    assert chip_for_dtype(DEFAULT_CHIP, "float32").peak_flops == 67e12
    cand = {"block_b": 1}
    base = at.predict_time_s(kernel, problem, cand, dtype=dtype)
    slow_f32 = dataclasses.replace(DEFAULT_CHIP, peak_f32_flops=1e12)
    slow_tc = dataclasses.replace(DEFAULT_CHIP, peak_flops=1e12, peak_int8_ops=1e12)
    assert at.predict_time_s(kernel, problem, cand, dtype=dtype, chip=slow_f32) > base
    assert at.predict_time_s(kernel, problem, cand, dtype=dtype, chip=slow_tc) == base


def test_a_wrapper_reaches_the_tuner_once_a_shape(monkeypatch):
    calls = []
    real = at.autotune
    monkeypatch.setattr(at, "autotune", lambda *a, **kw: calls.append(a[0]) or real(*a, **kw))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 3, 6)).astype(np.float32))
    w, u, b = torch.zeros(6, 80), torch.zeros(20, 80), torch.zeros(80)
    h = torch.zeros(5, 20)
    for _ in range(100):
        k3.lstm_seq_fused(x, w, u, b)
        k2.lstm_cell_fused(x[:, 0], h, h, w, u, b)
    assert calls == ["lstm_seq", "lstm_cell"]


def test_no_tuning_inside_a_capture(monkeypatch):
    """An uncached key raises while the current stream is being captured
    (the tuner reads and writes the disk and takes a lock); a cached one is
    served."""
    cached = at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert at.autotune("int8_matmul", PROBLEM, dtype="int8", backend="cpu") == cached
    with pytest.raises(RuntimeError, match="capture"):
        at.autotune("int8_matmul", {"m": 4, "k": 64, "n": 64}, dtype="int8", backend="cpu")


def test_chip_model_and_runtime_agree():
    assert runtime.MAX_SHARED_BYTES == DEFAULT_CHIP.smem_per_block == 232448
    assert runtime.SM_COUNT == DEFAULT_CHIP.sms == 132
    assert k3.CLUSTER == DEFAULT_CHIP.cluster_size
    assert at.chip_with_slots(None) is at.chip_with_slots(15) is DEFAULT_CHIP
    assert at.chip_with_slots(30).name != DEFAULT_CHIP.name
