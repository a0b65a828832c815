"""Shape-keyed, cost-model-driven launch-geometry tuner for the port's kernels.

The paper's Generator picks hardware design points by pruning a candidate
space with *analytical models* first and only then evaluating survivors
(§2.2/§2.3).  This module applies the same method to the launch geometry
of the CUDA kernels: each kernel's ``block_* = "auto"`` routes here, where we

  1. enumerate the candidates the kernel accepts for the problem shape
     (rows a block or a cluster for the LSTM kernels, K5's built tiles
     times its K chunks, K6's built tiles),
  2. prune with the kernel's own shared-memory count against the
     ``core.energy.H100Chip`` (a block's 227 KB, the clusters the card
     holds at once) and rank by an analytic time model built on the
     ``core.cost_model`` roofline,
  3. optionally refine the analytic top-k by timing them on the card
     (``measure_fn``, e.g. ``kernels.bench.make_measure_fn``), and
  4. cache the winner in-process and on disk, keyed by
     (kernel, shape, dtype, backend, chip) — deterministic for a given key.

Supported kernels and their problem dicts:

  lstm_cell       {batch, d_in, hidden}                    → block_b  (K2 rows a block)
  lstm_seq        {batch, seq, d_in, hidden}               → block_b  (K3 rows a block or cluster)
  lstm_stack      {batch, seq, d_in, hidden, layers}       → block_b  (K4, as K3)
  int8_matmul     {m, k, n[, batch]}                       → block_m, block_n, block_k (K5)
  flash_attention {b, h, sq, sk, d}                        → block_q, block_k (K6)

**The time model.**  The reference's LSTM model is a roofline over weights
streamed once per batch block, which prefers the coarsest tile.  On the
H100 the S dependent steps of a recurrence are latency-bound: spreading
the rows over SMs and clusters is fastest.  So the LSTM models count waves
(tiles over the blocks or clusters the card holds at once) × steps × a
per-step latency that grows with the rows a block carries, plus, per path,
what it pays besides: the layer's fixed start (loading u's slice), the
input projection's re-staging of w at every chunk of steps (cluster path),
and the weight bytes each step re-reads from L2 (l2 path).  The latencies
are fitted to measured device times on an NVIDIA H100 80GB HBM3 at 700 W
(each constant names its run).  Weights at int8 change bytes and the
fitted latencies, not the rate: the LSTM kernels widen int8 to f32 and run
IEEE f32 multiply-adds on the CUDA cores, so every LSTM model is scored
against the f32 peak.  K5 is bound by the weight's bytes: its model
counts the bytes each wave of resident blocks moves at the share of the
memory rate that its loads in flight can draw, the bytes of the busiest SM,
a fixed launch cost, and what each extra chunk of K costs (its partial
sums, and its prologue); chunks shorter than the kernel's cp.async ring are
not candidates.  A batch of E products (the MoE expert einsums, one launch)
counts the tiles, bytes and operations of all E: a split of K that fills
the card for one product leaves E of them over-split.  K6 has one built tile per type: its model is its roofline.

The cache key is ``kernel|dims|dtype|backend|chip.name:smem_per_block``;
the disk file (``<tmpdir>/repro_torch_autotune_cache.json``, relocated by
``REPRO_AUTOTUNE_CACHE``) also records :data:`MODEL`, and a file written
under another model is ignored.  ``autotune`` must never run inside a CUDA
graph capture (it reads and writes the disk and takes a lock): the
wrappers memoize each resolved shape, so the warm-up run before a capture
resolves it, and ``autotune`` raises for an uncached key during a capture.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import threading
from typing import Callable, Mapping

import torch

from repro_torch.core.cost_model import F32, Roofline, chip_for_dtype, dtype_bytes
from repro_torch.core.energy import DEFAULT_CHIP, H100Chip
from repro_torch.kernels import flash_attention as _k6
from repro_torch.kernels import int8_matmul as _k5
from repro_torch.kernels import lstm_cell as _k2
from repro_torch.kernels import lstm_seq as _k3
from repro_torch.kernels.runtime import backend_key

# The model's version: disk entries written under another are ignored.
MODEL = "h100-waves-6"

# --- fitted constants (NVIDIA H100 80GB HBM3, 700 W) -----------------------
# The cluster path and K5 are linear in their constants: a launch's predicted
# seconds are the dot product of its features (:func:`features`) with the
# fit below, which chip_smoke.py's tuner phase refits from its own timings
# on every run and prints beside these (``tuner.fit``).
#
# K3/K4 cluster path, by weight type: seconds per (wave x layer), per (wave x
# layer x step), per (wave x layer x step x row of a cluster) and per (wave x
# layer x extra chunk of the input projection), where a wave is as many
# clusters as the card holds at once.  Least squares (relative error) over the
# device times of chip_smoke.py's tuner phase in runs B-E of the tuner's
# calibration (PERF.md §6), averaged per tile: K3 and K4 at
# (40, 28, 256, 256) and (200, 28, 256, 256), every tile up to 16 rows.
CLUSTER_FIT = {"float32": (0.09180e-6, 2.570e-6, 0.6774e-6, 14.41e-6),
               "int8": (0.08888e-6, 2.489e-6, 0.7830e-6, 13.98e-6)}
# K3/K4 block and l2 paths, per layer-step: BLOCK_STEP_S + rows x (D + H) x 4H
# multiply-adds at BLOCK_FMA_RATE a block, at most the SM's f32 rate shared by
# the blocks on it (chip_smoke.py's kernels line: K3 at (64, 28, 6, 20) and
# (32, 64, 16, 32), one row a block, 1.75 and 1.64 µs a step; PERF.md §6).
BLOCK_STEP_S = 1.70e-6
BLOCK_FMA_RATE = 72e9
# K2, per wave: CELL_S + the busiest SM's weight slices at its share of the
# memory rate + its rows x (D + H) x 32 multiply-adds at CELL_FMA_RATE a block
# (chip_smoke.py's kernels line: 6.68 µs at 40x256x256, 10 rows; 3.32 µs at
# 64x6x20, 2 rows; PERF.md §6).
CELL_S = 3.16e-6
CELL_FMA_RATE = 172e9
# K5: seconds per launch, per byte the grid moves at the memory share its
# loads in flight can draw (16-, 64- and 128-row tiles apart), per padded
# int8 operation at the share of the SMs its grid fills, per byte of split-K
# partial sums, per extra chunk of K (16-row tiles; the others), and per byte
# of the busiest SM (64- and 128-row tiles apart).  Least squares (relative
# error, coefficients >= 0) over the K5 timings of runs B-E, averaged per
# candidate: the weights read from device memory, every projection of
# granite-3-8b at M = 4, 20, 32, 64 and 256, 1 to 32 chunks.
K5_FIT = (7.116e-6, 2.178e-13, 3.641e-13, 5.046e-13, 0.0, 1.013e-12, 0.0, 0.4848e-6,
          7.800e-14, 8.036e-14)
# bytes of loads in flight that draw the whole memory rate: two 16 x 128
# blocks an SM, each with its 4 stages of 64 bytes of k; the 64- and 128-row
# tiles' eight warps draw it with K5_INFLIGHT_BIG of that (the value that
# fitted runs B and C best in a scan of 0.3-1.0)
K5_INFLIGHT_FULL = 2 * 132 * 4 * (16 + 128) * 64
K5_INFLIGHT_BIG = 0.75
# registers a thread of each K5 tile's kernel (ptxas, the vectorized
# instantiation; chip_smoke.py's tensor_core_kernels.ptxas): they bound the
# blocks an SM holds
K5_REGISTERS = {(16, 64): 72, (16, 128): 96, (64, 128): 105, (128, 128): 128}
# L2 rate, bytes/s: the l2 path's per-step weight reads (chip_smoke.py's energy
# line, run A: an 8 MB device copy, 8 MB read and 8 MB written)
L2_BW = 1.87e12


@dataclasses.dataclass(frozen=True)
class _Analysis:
    """What the model knows of one (problem, candidate) pair."""

    hbm_bytes: float    # bytes to and from device memory
    smem_bytes: int     # dynamic shared memory of one block
    blocks: int         # thread blocks of the launch
    time_s: float       # predicted device time


def _even_tiles(batch: int) -> list[int]:
    """Tiles ceil(batch / n), n = 1..batch: for each count of tiles the
    smallest tile that gives it (any other tile carries more rows for the
    same count)."""
    out, n = [], 1
    while n <= batch:
        bb = -(-batch // n)
        out.append(bb)
        n = -(-batch // (bb - 1)) if bb > 1 else batch + 1
    return sorted(out)


@functools.lru_cache(maxsize=None)
def chip_with_slots(slots: int | None) -> H100Chip:
    """The chip model with the card's own count of cluster slots (the
    wrappers ask the card: ``lstm_seq.cluster_slots``); a count other than
    the model's gives a chip of its own name, so that its winners are
    cached apart.  None: the model as it is."""
    if slots is None or slots == DEFAULT_CHIP.cluster_slots:
        return DEFAULT_CHIP
    return dataclasses.replace(DEFAULT_CHIP, name=f"{DEFAULT_CHIP.name}/{slots}-clusters",
                               cluster_slots=slots)


def _fma_rate_per_sm(chip: H100Chip) -> float:
    return chip_for_dtype(chip, "float32").peak_flops / 2 / chip.sms


def _resident(chip: H100Chip, smem: int, threads: int) -> int:
    """Blocks an SM holds at once, by shared memory, threads and its cap."""
    return max(1, min(chip.blocks_per_sm, chip.threads_per_sm // threads,
                      chip.smem_per_sm // max(smem + 1024, 1)))


def _dot(features, fit) -> float:
    return float(sum(f * c for f, c in zip(features, fit)))


def _cluster_features(waves: int, layers: int, seq: int, rows: int,
                      chunks: int) -> tuple[float, ...]:
    return (waves * layers, waves * layers * seq, waves * layers * seq * rows,
            waves * layers * (chunks - 1))


def _roofline_s(flops: float, nbytes: float, dtype: str, chip: H100Chip) -> float:
    return Roofline(flops, nbytes, 0.0, 1, flops, chip_for_dtype(chip, dtype)).t_step_s


# ---------------------------------------------------------------------------
# K2-K4: the LSTM kernels
# ---------------------------------------------------------------------------
def _lstm_weight_bytes(p: Mapping[str, int], dtype: str = "float32",
                       d_in: int | None = None) -> float:
    """One layer's w+u+bias bytes at the WEIGHT dtype.  int8 additionally
    carries two 4H f32 per-gate-column scale vectors (lstm_quant)."""
    d = p["d_in"] if d_in is None else d_in
    hid = p["hidden"]
    wb = dtype_bytes(dtype)
    payload = (d + hid) * 4 * hid * wb
    bias = 4 * hid * F32
    scales = 2 * 4 * hid * F32 if "int8" in dtype else 0
    return float(payload + bias + scales)


def _lstm_stack_weight_bytes(p: Mapping[str, int], dtype: str) -> float:
    """All L layers: layer 0 projects from d_in, layers 1.. from hidden."""
    first = _lstm_weight_bytes(p, dtype)
    rest = _lstm_weight_bytes(p, dtype, d_in=p["hidden"])
    return first + (p["layers"] - 1) * rest


def _lstm_blocks(p: Mapping[str, int]) -> list[dict]:
    return [{"block_b": bb} for bb in _even_tiles(p["batch"])]


def _weight_type(dtype: str) -> str:
    return "int8" if "int8" in dtype else "float32"


def _seq_plan(p: Mapping[str, int], c: Mapping[str, int], dtype: str):
    """K3/K4's plan for the candidate (its path follows from the rows), or
    None where the kernel refuses it."""
    try:
        return _k3.plan_for(c["block_b"], p["batch"], p["seq"], p["d_in"], p["hidden"],
                            layers=p.get("layers", 1), quantized="int8" in dtype)
    except ValueError:
        return None


def _lstm_seq_analyze(p: Mapping[str, int], c: Mapping[str, int], dtype: str = "float32",
                      chip: H100Chip = DEFAULT_CHIP) -> _Analysis | None:
    bsz, seq, d, hid = p["batch"], p["seq"], p["d_in"], p["hidden"]
    layers = p.get("layers", 1)
    plan = _seq_plan(p, c, dtype)
    if plan is None:
        return None
    bb, wt = plan.block_b, _weight_type(dtype)
    wbytes = _lstm_stack_weight_bytes(p, dtype) if layers > 1 else _lstm_weight_bytes(p, dtype)
    # x in, the last layer's hs out, every layer's final (h, c) out; the
    # weights once (the inter-layer sequence stays on chip or in L2)
    traffic = wbytes + bsz * seq * (d + hid) * F32 + 2 * layers * bsz * hid * F32
    if plan.path == "cluster":
        waves = -(-plan.clusters // chip.cluster_slots)
        chunks = -(-seq // plan.chunk)
        time_s = _dot(_cluster_features(waves, layers, seq, bb, chunks), CLUSTER_FIT[wt])
        blocks = plan.clusters * plan.cluster
    else:
        threads = min(1024, -(-4 * hid // 32) * 32)
        per_sm = _resident(chip, plan.smem_bytes, threads)
        waves = -(-plan.clusters // (chip.sms * per_sm))
        sharing = min(per_sm, -(-plan.clusters // chip.sms))  # blocks sharing an SM
        rate = min(BLOCK_FMA_RATE, _fma_rate_per_sm(chip) / sharing)
        width = (max(d, hid) if layers > 1 else d) + hid
        step = BLOCK_STEP_S + bb * width * 4 * hid / rate
        if plan.path == "l2":  # each step re-reads the layer's weights from L2
            step += sharing * _lstm_weight_bytes(p, dtype) / (L2_BW / chip.sms)
        time_s = waves * layers * seq * step
        blocks = plan.clusters
    return _Analysis(float(traffic), plan.smem_bytes, blocks, time_s)


def _lstm_cell_analyze(p: Mapping[str, int], c: Mapping[str, int], dtype: str = "float32",
                       chip: H100Chip = DEFAULT_CHIP) -> _Analysis | None:
    bsz, d, hid = p["batch"], p["d_in"], p["hidden"]
    try:
        plan = _k2.plan_for(c["block_b"], bsz, d, hid)
    except ValueError:
        return None
    blocks = plan.grid[0] * plan.grid[1]
    per_sm = _resident(chip, plan.smem_bytes, _k2.THREADS)
    waves = -(-blocks // (chip.sms * per_sm))
    sharing = min(per_sm, -(-blocks // chip.sms))
    k = d + hid
    slice_bytes = k * 4 * plan.units * F32
    # the busiest SM's blocks: their weight slices at its share of the memory
    # rate, their multiply-adds at their own rate up to the SM's f32 peak
    rate = min(sharing * CELL_FMA_RATE, _fma_rate_per_sm(chip))
    per_wave = (CELL_S + sharing * slice_bytes / (chip.hbm_bw / chip.sms)
                + sharing * plan.rows * k * 4 * plan.units / rate)
    traffic = _lstm_weight_bytes(p, dtype) + bsz * (d + 4 * hid) * F32  # x,h,c in; h,c out
    return _Analysis(float(traffic), plan.smem_bytes, blocks, waves * per_wave)


# ---------------------------------------------------------------------------
# K5 int8_matmul
# ---------------------------------------------------------------------------
def _int8_matmul_candidates(p: Mapping[str, int]) -> list[dict]:
    """The built tiles for the problem's rows (16-row tiles for decode, m <=
    16; 64- and 128-row tiles above), times every K chunk, a multiple of
    BLOCK_K, that gives a distinct number of chunks (at most 65535 / batch
    of them: the batch shares the kernel's grid z with the chunks)."""
    pairs = [t for t in _k5.TILES if (t[0] == _k5.SMALL_M) == (p["m"] <= _k5.SMALL_M)]
    most = 65535 // p.get("batch", 1)
    return [{"block_m": bm, "block_n": bn, "block_k": bk}
            for bm, bn in pairs for bk in k_chunks(p["k"]) if -(-p["k"] // bk) <= most]


def k_chunks(k: int) -> list[int]:
    """K5's chunks of K, in bytes: a multiple of BLOCK_K for each distinct
    number of chunks, none shorter than the kernel's cp.async ring (STAGES
    x BLOCK_K bytes) unless K is: a shorter chunk never fills the ring, and
    its prologue is not amortised."""
    ring = _k5.STAGES if k > _k5.STAGES * _k5.BLOCK_K else 1
    return [per * _k5.BLOCK_K for per in _even_tiles(-(-k // _k5.BLOCK_K)) if per >= ring]


def _k5_plan(p: Mapping[str, int], c: Mapping[str, int]):
    return _k5.plan_for(p["m"], p["k"], p["n"], c["block_m"], c["block_n"], c["block_k"],
                        p.get("batch", 1))


def _int8_matmul_analyze(p: Mapping[str, int], c: Mapping[str, int], dtype: str = "int8",
                         chip: H100Chip = DEFAULT_CHIP) -> _Analysis | None:
    m, k, n, e = p["m"], p["k"], p["n"], p.get("batch", 1)
    try:
        plan = _k5_plan(p, c)
    except ValueError:
        return None
    bm, bn = plan.block_m, plan.block_n
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    # the weight is read once per row of tiles, x once per column of tiles
    traffic = e * (k * n * m_tiles + m * k * n_tiles + 4 * m * n
                   + 4 * (m * n_tiles + n * m_tiles))
    return _Analysis(float(traffic), _k5.smem_bytes(bm, bn), plan.blocks(m, n, e),
                     _dot(_k5_features(p, plan, chip), K5_FIT))


def _k5_features(p: Mapping[str, int], plan, chip: H100Chip) -> tuple[float, ...]:
    """(1, bytes at the memory share of 16-, of 64- and of 128-row tiles,
    padded int8 operations at the SM share, partial-sum bytes, extra chunks
    of 16-row tiles and of the others, bytes of the busiest SM of 64- and
    of 128-row tiles): the grid runs in waves of the blocks the SMs hold at
    once (registers, shared memory), and a wave draws the memory rate in
    proportion to its loads in flight.  A batch's E products count E times
    over, in one grid."""
    m, k, n, e = p["m"], p["k"], p["n"], p.get("batch", 1)
    bm, bn = plan.block_m, plan.block_n
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    blocks = plan.blocks(m, n, e)
    traffic = e * (k * n * m_tiles + m * k * n_tiles + 4 * m * n)
    small = bm == _k5.SMALL_M
    full = K5_INFLIGHT_FULL * (1.0 if small else K5_INFLIGHT_BIG)
    threads = _k5.threads(bm, bn)
    regs = -(-K5_REGISTERS[(bm, bn)] // 8) * 8 * threads
    per_sm = max(1, min(chip.registers_per_sm // regs, chip.threads_per_sm // threads,
                        chip.smem_per_sm // (_k5.smem_bytes(bm, bn) + 1024), chip.blocks_per_sm))
    capacity = chip.sms * per_sm
    per_block = traffic / blocks
    flight = _k5.STAGES * (min(bm, m) + min(bn, n)) * _k5.BLOCK_K
    moved, left = 0.0, blocks
    while left > 0:
        wave = min(left, capacity)
        left -= wave
        moved += wave * per_block / (chip.hbm_bw * min(1.0, wave * flight / full))
    moved *= chip.hbm_bw  # bytes at full rate: the fit scales them
    ops = 2.0 * e * m_tiles * bm * n_tiles * bn * k / min(1.0, blocks / chip.sms)
    # each chunk adds its real rows into the int32 workspace, the last reads them back
    partial = e * (plan.split_k + 1) * m * n * 4 if plan.split_k > 1 else 0.0
    splits = plan.split_k - 1
    # the bytes of the busiest SM, at its share of the rate: a grid a little
    # over a multiple of the SMs leaves some of them two blocks' work
    busiest = -(-blocks // chip.sms) * per_block * chip.sms
    rows = (bm == _k5.SMALL_M, bm == 64, bm == 128)
    return (1.0, *(moved * r for r in rows), ops / chip_for_dtype(chip, "int8").peak_flops,
            partial, splits if small else 0.0, 0.0 if small else splits,
            *(busiest * r for r in rows[1:]))


# ---------------------------------------------------------------------------
# K6 flash_attention
# ---------------------------------------------------------------------------
def _flash_candidates(p: Mapping[str, int], dtype: str = "float32") -> list[dict]:
    bq, bk = _k6.BUILT_TILES[_flash_type(dtype)]
    return [{"block_q": bq, "block_k": bk}]


def _flash_type(dtype: str) -> str:
    return "bfloat16" if "bfloat16" in dtype else "float32"


def _flash_analyze(p: Mapping[str, int], c: Mapping[str, int], dtype: str = "float32",
                   chip: H100Chip = DEFAULT_CHIP) -> _Analysis | None:
    b, h, sq, sk, d = p["b"], p["h"], p["sq"], p["sk"], p["d"]
    kind = _flash_type(dtype)
    if (c["block_q"], c["block_k"]) != _k6.BUILT_TILES[kind]:
        return None
    esize = dtype_bytes(kind)
    flops = 4.0 * b * h * sq * sk * d
    # q in and o out once; k and v read once per tile of queries
    traffic = 2 * b * h * sq * d * esize + 2 * b * h * -(-sq // c["block_q"]) * sk * d * esize
    blocks = b * h * -(-sq // c["block_q"])
    smem = _k6.flash_smem_bytes(d, kind)
    time_s = _roofline_s(flops, traffic, kind, chip) / min(1.0, blocks / chip.sms)
    return _Analysis(float(traffic), smem, blocks, time_s)


_KERNELS: dict[str, tuple[Callable, Callable]] = {
    "int8_matmul": (_int8_matmul_candidates, _int8_matmul_analyze),
    "flash_attention": (_flash_candidates, _flash_analyze),
    "lstm_cell": (_lstm_blocks, _lstm_cell_analyze),
    "lstm_seq": (_lstm_blocks, _lstm_seq_analyze),
    "lstm_stack": (_lstm_blocks, _lstm_seq_analyze),
}
# the fields a kernel's candidates carry: what a cache entry may hold
_FIELDS = {"int8_matmul": {"block_m", "block_n", "block_k"},
           "flash_attention": {"block_q", "block_k"},
           "lstm_cell": {"block_b"}, "lstm_seq": {"block_b"}, "lstm_stack": {"block_b"}}


def _candidates(kernel: str, problem: Mapping[str, int], dtype: str) -> list[dict]:
    gen, _ = _KERNELS[kernel]
    return gen(problem, dtype) if kernel == "flash_attention" else gen(problem)


def _analyze(kernel: str, problem, candidate, dtype: str, chip: H100Chip):
    _, analyze = _KERNELS[kernel]
    return analyze(problem, candidate, dtype, chip)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------
def features(kernel: str, problem: Mapping[str, int], candidate: Mapping[str, int], *,
             dtype: str = "float32", chip: H100Chip = DEFAULT_CHIP):
    """(fit, features) of a candidate whose predicted time is linear in a fit
    of this module: ``"cluster/float32"`` or ``"cluster/int8"``
    (:data:`CLUSTER_FIT`) for K3/K4 on the cluster path, ``"int8_matmul"``
    (:data:`K5_FIT`) for K5; None for the others.  Predicted seconds are the
    dot product of the features with the fit: a refit is linear least
    squares over measured times."""
    if kernel in ("lstm_seq", "lstm_stack"):
        plan = _seq_plan(problem, candidate, dtype)
        if plan is None or plan.path != "cluster":
            return None
        waves = -(-plan.clusters // chip.cluster_slots)
        return (f"cluster/{_weight_type(dtype)}",
                _cluster_features(waves, problem.get("layers", 1), problem["seq"],
                                  plan.block_b, -(-problem["seq"] // plan.chunk)))
    if kernel == "int8_matmul":
        return "int8_matmul", _k5_features(problem, _k5_plan(problem, candidate), chip)
    return None


FITS = {"cluster/float32": CLUSTER_FIT["float32"], "cluster/int8": CLUSTER_FIT["int8"],
        "int8_matmul": K5_FIT}


def vmem_footprint_bytes(kernel: str, problem: Mapping[str, int],
                         candidate: Mapping[str, int], *, dtype: str = "float32",
                         chip: H100Chip = DEFAULT_CHIP) -> float:
    """Shared-memory bytes one thread block of the candidate uses (the name
    is the reference's, whose TPU kernels kept their tiles in VMEM); the
    kernels' own counts (``seq_smem_bytes``, ``cluster_smem_bytes``,
    ``cell_smem_bytes``, ``flash_smem_bytes``, K5's stages).  Infinite where
    the kernel refuses the candidate."""
    a = _analyze(kernel, problem, candidate, dtype, chip)
    return float("inf") if a is None else float(a.smem_bytes)


def is_feasible(kernel: str, problem: Mapping[str, int],
                candidate: Mapping[str, int], chip: H100Chip = DEFAULT_CHIP,
                *, dtype: str = "float32") -> bool:
    """The kernel takes the candidate and one block's shared memory fits
    ``chip.smem_per_block``; a cluster plan also needs a cluster slot."""
    a = _analyze(kernel, problem, candidate, dtype, chip)
    return (a is not None and a.smem_bytes <= chip.smem_per_block
            and (kernel not in ("lstm_seq", "lstm_stack") or chip.cluster_slots >= 1))


def predict_time_s(kernel: str, problem: Mapping[str, int],
                   candidate: Mapping[str, int], *, dtype: str = "float32",
                   chip: H100Chip = DEFAULT_CHIP) -> float:
    """The analytic device time of one launch (see the module docstring)."""
    a = _analyze(kernel, problem, candidate, dtype, chip)
    if a is None:
        raise ValueError(f"{kernel}: the kernel does not take {dict(candidate)} at {dict(problem)}")
    return a.time_s


def feasible_candidates(kernel: str, problem: Mapping[str, int],
                        chip: H100Chip = DEFAULT_CHIP, *,
                        dtype: str = "float32") -> list[dict]:
    return [c for c in _candidates(kernel, problem, dtype)
            if is_feasible(kernel, problem, c, chip, dtype=dtype)]


def ranked_candidates(kernel: str, problem: Mapping[str, int], *, dtype: str = "float32",
                      chip: H100Chip = DEFAULT_CHIP) -> list[dict]:
    """Feasible candidates, fastest predicted first; ties go to the coarser
    grid, then to the smaller fields."""
    def key(c):
        a = _analyze(kernel, problem, c, dtype, chip)
        return (a.time_s, a.blocks, tuple(sorted(c.items())))

    return sorted(feasible_candidates(kernel, problem, chip, dtype=dtype), key=key)


# ---------------------------------------------------------------------------
# Cache (in-process dict + JSON on disk)
# ---------------------------------------------------------------------------
_CACHE: dict[str, dict] = {}
_LOCK = threading.Lock()


def _cache_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(tempfile.gettempdir(), "repro_torch_autotune_cache.json"),
    )


def cache_key(kernel: str, problem: Mapping[str, int], dtype: str,
              backend: str | None = None, chip: H100Chip = DEFAULT_CHIP) -> str:
    backend = backend or backend_key()
    shape = ",".join(f"{k}={problem[k]}" for k in sorted(problem))
    # the chip's fingerprint: a winner tuned for one card's budget is never
    # served for another
    return f"{kernel}|{shape}|{dtype}|{backend}|{chip.name}:{chip.smem_per_block}"


def _valid_entry(kernel: str, value) -> bool:
    """Disk entries are untrusted (a shared temporary directory by default):
    accept only the kernel's own candidate fields, each a positive int."""
    return (
        isinstance(value, dict)
        and set(value) == _FIELDS[kernel]
        and all(isinstance(v, int) and not isinstance(v, bool) and v > 0
                for v in value.values())
    )


def _load_disk() -> dict:
    try:
        with open(_cache_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("model") != MODEL:
        return {}
    entries = data.get("entries")
    return entries if isinstance(entries, dict) else {}


def _store_disk(key: str, value: dict) -> None:
    path = _cache_path()
    entries = _load_disk()
    entries[key] = value
    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump({"model": MODEL, "entries": entries}, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # disk cache is best-effort; in-process cache still holds it


def clear_cache(*, disk: bool = False) -> None:
    with _LOCK:
        _CACHE.clear()
        if disk:
            try:
                os.remove(_cache_path())
            except OSError:
                pass


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def autotune(kernel: str, problem: Mapping[str, int], *, dtype: str = "float32",
             backend: str | None = None, chip: H100Chip = DEFAULT_CHIP,
             measure_fn: Callable[[dict], float] | None = None,
             top_k: int = 3) -> dict:
    """Pick the launch geometry of ``kernel`` on ``problem``.

    Deterministic for a given (kernel, shape, dtype, backend, chip) key:
    candidates are ranked by :func:`ranked_candidates`.  When
    ``measure_fn`` (candidate → seconds) is given, the analytic top-k are
    re-ranked by it before caching; an explicit ``measure_fn`` always
    re-tunes (cache hits serve analytic calls only).  Raises
    ``RuntimeError`` for a key it would have to tune while the current CUDA
    stream is being captured into a graph."""
    if kernel not in _KERNELS:
        raise ValueError(f"no autotune model for kernel {kernel!r}")
    key = cache_key(kernel, problem, dtype, backend, chip)
    if measure_fn is None and key in _CACHE:
        return dict(_CACHE[key])
    if _capturing():
        raise RuntimeError(f"autotune({key}) inside a CUDA graph capture: resolve the shape "
                           "before the capture (run the step once uncaptured)")
    with _LOCK:
        if measure_fn is None:
            disk = _load_disk().get(key)
            if _valid_entry(kernel, disk):
                _CACHE[key] = disk
                return dict(disk)

    scored = ranked_candidates(kernel, problem, dtype=dtype, chip=chip)
    if not scored:
        # nothing fits: hand back the smallest candidate uncached, which the
        # kernel's plan then refuses with its own bound
        return min(_candidates(kernel, problem, dtype),
                   key=lambda c: (vmem_footprint_bytes(kernel, problem, c, dtype=dtype,
                                                       chip=chip), tuple(sorted(c.items()))))
    if measure_fn is not None and len(scored) > 1:
        head = scored[: max(top_k, 1)]
        best = min(head, key=lambda c: (measure_fn(dict(c)), tuple(sorted(c.items()))))
    else:
        best = scored[0]

    best = dict(best)
    with _LOCK:
        _CACHE[key] = best
        _store_disk(key, best)
    return dict(best)
