#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds every CUDA kernel of ``src/repro_torch/csrc`` from source, holds each
against its plain PyTorch version on the card at the shapes its path uses,
times kernel, plain version and (where one PyTorch call computes the same
function) the library, then drives twelve paths, each with the launch
counters set to 0 just before it and read just after (on each, every decode
attention call on the card, ``attn.decode_calls``, must have launched K7
``decode_attention`` once):

* the paper-LSTM path — the plan and request batches through ``lstm_apply``
  and ``lstm_stack_apply`` in every mode (K1–K4);
* ``serve_dense`` — int8-weight serving of granite-3-8b at full width (8 of
  its 40 layers, bf16, ``quant="int8"``) through ``InferenceEngine.generate``
  and the slot path ``make_pool`` → ``prefill_into_slot`` →
  ``masked_decode_step`` (a replayed CUDA graph), every projection through
  ``int8_matmul`` (K5);
* ``serve_engine`` — the same weights with ``spec_slack=4``: chunked prefill
  of 2 x 64 tokens in chunks of 16 while two slots decode, speculative
  verify (K = 4) teacher-forced from the plain decode chain (per-position
  agreement >= 0.95, accept-0 on always-wrong drafts), poison → quarantine
  → ``resume_into_slot``, the replayed decode and verify ticks held bit for
  bit to the same steps run eagerly, and the reduced granite config in f32
  with int8 weights: chunked == blocking and speculative == plain, token
  for token.  K5 launches 7 x layers times a chunk, verify and replayed
  tick;
* ``serve_paged`` — the paged KV cache on the same weights: a paged engine
  (``ServeConfig(4, 128, paged=True, page_size=16)``, no ``spec_slack``)
  beside the contiguous one of ``serve_engine``: the plain chains of four
  slots (held to the contiguous engine's under the near-tie rule of
  ``chains_near_tie``: the two attend over 160 and 132 rows), verify K = 4
  teacher-forced from the paged chain, the replayed decode and verify ticks
  bit for bit against their eager runs, 56 K5 launches a replay as the
  contiguous ticks, the two replayed ticks timed in turns and profiled (the
  paged tick's extra kernels: its gather and scatter), a fork whose shared
  pages keep their bytes (one copy-on-write), ``swap_out`` / ``swap_in``
  bit for bit, poison / quarantine / resume with the scratch page zeroed
  after the flagged tick, a group of 4 prompts sharing a 64-token prefix (1
  chunk step instead of 5, 16 shared pages, chains held to the unshared
  group's), a pool of int8 KV pages (``quantize_kv`` on the card equal to
  the CPU's bytes on a tick's rows), a pool of 17 pages (2 contiguous
  slots' bytes) serving 4 requests with ``paged_cache_bytes`` allocated,
  and the reduced configs of granite-3-8b, deepseek-v3-671b, mamba2-780m,
  zamba2-7b and whisper-tiny in f32, paged = contiguous token for token;
* ``duty_cycle`` — the paper's RQ2 layer on the same int8 weights
  (``ServeConfig(max_batch=4, max_len=128)``): ``WorkloadAwareServer``'s
  ``measure_latency`` (the eager ``generate`` of 4 x 16 prompts, 8 new
  tokens; the median of 3) beside ``serve_engine``'s replayed decode tick;
  the three ``AccelProfile`` constants measured for this engine
  (``power.draw`` idle and during a 2.5 s ``generate`` loop, a pinned
  host-to-device copy of its weight tensors) beside ``H100Chip`` and
  ``gpu_reload_costs``; ``compare_strategies`` under the chip's profile and
  the measured one on regular traces at 0.05 and 20 break-even τ and a
  seeded bursty trace, the engine run during each (on-off <= idle-waiting
  at short gaps, idle-waiting <= on-off at long, adaptive >= 0.45 x the
  best); a ``StreamingTauPolicy`` refitting on the card within 10% of
  offline ``learn_tau``; ``NgramDrafter`` + ``SpecThrottle`` drafts for 4
  periodic prompts verified on the replayed verify tick, each chain held
  at every position against plain decode teacher-forced on it: the same
  token or a near tie (decode runs K7, verify the chunk's attention).  K5
  launches 56 a model call;
* ``serve_scheduler`` — the continuous-batching scheduler
  (``serving/scheduler.py``) over the same int8 weights: a contiguous
  engine (``ServeConfig(4, 128, spec_slack=4)``) and its paged twin
  (``ServeConfig(4, 128, paged=True, page_size=16)``), costs measured on the
  card by ``EngineCalibration`` (its decode and verify ticks on pools of its
  own, dropped after), a seeded Poisson stream of 16 requests (prompts of
  16, 32 or 48 tokens, 8-24 new tokens) at 8 arrivals a mean service time;
  continuous, chunked (chunks of 16) and speculative (K = 4) runs, each
  twice on one scheduler (the second timed and bit for bit the first), and
  static batches; every chunked and speculative chain held to the
  continuous one under ``serve_paged``'s near-tie rule (the margin read by
  replaying the request alone, ``replay_alone``); the "light" fault profile
  (quarantine and retry, none failed); the paged engine on a pool of 11
  pages, half the stream's worst case, with half the requests on the
  latency tier, preempting by swap (tokens exactly the unpressured paged
  run's) and by recompute (near ties); a 300 W cap under the brownout
  ladder (no window over it) and an energy budget of twice the idle floor
  a 0.25 s window (no window over it), their tokens exactly the
  continuous run's; the reduced configs of the five cache layouts in f32
  through the scheduler on the card and on the CPU, the two reports equal
  field for field; and ``python -m repro_torch.launch.serve --arch
  granite-3-8b --mode compare --paged --n 12``, which must return 0.  Its
  line gives the calibrated costs beside ``serve_engine``'s replayed
  ticks, the scheduler's own host time a tick, items/J and virtual
  p50/p99 a mode under ``H100Chip``, and K5 launches a committed token;
* ``serve_moe`` — the moe family through the same engine: granite-moe-3b-a800m
  at full width and full depth (32 layers, 48 padded experts, bf16, int8:
  ``generate``, the slot path with replayed ticks, a chunked prefill while
  slots decode, a verify tick of K = 4 teacher-forced from the plain chain),
  then deepseek-v3-671b at full width cut to 2 layers (one MLA + dense-MLP,
  one MLA + MoE with 256 experts and a shared one: ``generate`` and replayed
  ticks), each with its replayed ticks bit for bit equal to the eager ones,
  greedy agreement with its bf16 twin >= 0.3 and one block on the card
  against the CPU; then both reduced configs in f32 (granite-moe's with int8
  weights; deepseek's MLA prefill and chunk paths round int8 differently, so
  its identities hold with full-precision weights only), chunked == blocking
  and speculative == plain, token for token.  Every
  expert einsum is ONE K5 launch over the expert axis; the counts a call
  makes are ``k5_per_call``'s;
* ``serve_ssm`` — the ssm and hybrid families through the same engine, each
  at full width and full depth: mamba2-780m (48 Mamba2 layers) and zamba2-7b
  (81 Mamba2 layers, the weight-shared attention block applied 14 times),
  bf16 with int8 weights and a bf16 twin: ``generate``, the slot path with
  the replayed decode tick timed and profiled beside the bytes it must move,
  a chunked prefill while slots decode, verify ticks teacher-forced from the
  plain chain (each row's conv tail and SSM state rolled to its own accepted
  count), accept-0, poison/resume, replayed ticks bit for bit equal to eager
  ones, a 512-token prompt (two 256-token SSD chunks) against its chunked
  composition, agreement with the bf16 twin >= 0.3, one Mamba2 block and
  the shared block on the card against the CPU; then both reduced configs
  in f32 with int8 weights, chunked == blocking and speculative == plain,
  token for token.  K5 launches 3 a Mamba2 layer and 9 a shared-block
  application a call (``k5_per_call``);
* ``serve_audio`` — the enc-dec audio family through the same engine:
  whisper-tiny at full width and full depth (4 encoder + 4 decoder layers,
  encoder_seq 1500, vocab 51865 tied), bf16 with int8 weights and a bf16
  twin, the same steps as ``serve_ssm`` (the chunked group's cross K/V from
  ``encoder_cross_cache`` of the front-end stub, the resumed slot's cross
  K/V a fresh prefill's, bit for bit), the replayed decode tick beside the
  bytes it must move (the decoder's weights, the tied table, the cross K/V
  of 4 slots), one prompt over seeded random frames held to its chunked
  composition, the encoder and decoder blocks on the card against the CPU;
  then the reduced config in f32 with int8 weights, token for token.  K5
  launches 6 an encoder layer, 10 a decoder layer at prefill and 8 at the
  other calls, every encoder and cross K/V product at M = B x 1500;
* ``serve_vlm`` — the vision-language model: internvl2-76b at full width
  (d_model 8192, 64 heads, GQA kv 8, d_ff 28672, vocab 128256 untied) cut
  80 → 8 layers, its prompts 256 image positions (the engine's stub) and
  then text, the same steps (the chunked prefill in chunks of 48, one of
  which straddles position 256; a prefill of seeded random patch
  embeddings against its chunked composition), 7 K5 launches a layer;
* ``flash_attention`` — its public op ``kernels.ops.flash_attention`` at a
  granite-shaped causal case (K6; no model path calls it);
* ``train`` — the training path, after the serving engines are dropped (no
  kernel of the port is on it: the reference trains in plain jnp):
  granite-3-8b at full width cut 40 → 8 layers, bf16, remat full, AdamW,
  its random attention weights rescaled (``attention_fan_in``, as the
  serving paths'; ``FanInTrainer``), 2 x 4096 tokens of synthetic bigram
  data, through the ``Trainer`` for 8
  steps with a ``WorkerFailure`` at step 4, before any checkpoint (one
  restart from the seeded init; steps 0-3 replayed on the same batches bit
  for bit, their losses within 1e-2), its final checkpoint (28 GB: one
  checkpoint of this size a run keeps the run's disk writes under 45 GiB)
  restored into a fresh Trainer, every leaf bit for bit the first
  Trainer's; the loss lower at the last step than at the first;
  ``loss_and_grads`` with accum=2 against accum=1 on one batch (loss and
  gradient norm within 2e-2); one step profiled.  mamba2-780m at full
  width and depth, 1 x 4096, 4 steps, every loss and gradient norm finite
  (the SSD scan's gradients, NaN in the reference).  The ten reduced configs
  in f32, one ``make_train_step`` step on the card against the CPU.  And
  ``examples/torch/train_lm.py --quick`` (granite-4m) for 300 steps of 16 x
  128 with a failure at 150 (the checkpoint of step 100 restored, its
  ``state_digest`` the trained state's, and replayed), its final loss under
  0.6 ln V.  Each reports step time, tokens/s, MFU against 989 TFLOP/s
  (``train_flops``), peak memory beside the state's bytes, and the idle
  share of the profiled step.
* ``plan_decode`` (after serve_scheduler) and ``plan`` (after train): the
  step cost model (``core/cost_model.estimate_step`` on ``H100Chip``)
  against this run's own measurements at full width, granite-3-8b at the
  paths' 8 layers: train_4k over ``MeshPlan(dp=128)`` (2 x 4096 a card)
  against the train path's step, and decode_32k over ``MeshPlan(dp=32)`` (4
  slots at ctx 32768 a card) against the replayed decode tick of
  serve_dense's int8 weights on a 4 x 32768 pool (4.3 GB of K/V), every
  slot's position at the capacity's last row but one (a NaN in a
  never-written row before it shows that the tick reads every row through
  the position, one past it that it reads no further); predicted,
  measured and their ratio, and ``GPUCostBackend``'s Generator pick for that
  engine on one card.
* ``examples``: ``examples/torch/{quickstart,generate_accelerator,
  serve_workload}.py`` through their ``main`` on the card (serve_workload
  with ``--n 12``, its int8 engine launching K5); ``train_lm --quick`` is
  ``train_converge``.
* ``multi_device`` (after plan): the mesh layer with several ranks on the
  one card, processes spawned over gloo (NCCL refuses two ranks on one card;
  gloo's collectives of CUDA tensors are staged through host memory
  at the port's choke point, ``core/collectives.py``, and the line names
  them).  In a world of 4 on a (2, 2) ("data", "model") mesh: (a) one
  granite-moe-3b-a800m MoE layer at full width with int8 experts, in the
  a2a mode (8 x 64 tokens, tp_split 2) and the gather mode (8 x 1), on rank
  0 (a2a: against ``md_moe_reference``, the dense layer's expert outputs
  over the routes a plain per-expert count keeps at capacity, 99.9% within
  5e-2 and 3e-2 of the largest |y|; gather: against the dense path, 3e-2 of
  the largest |y|), K5 launched 3 times a rank a call; (b) the Trainer,
  granite-3-8b at full width and 2 layers, AdamW, 4 x 512 tokens, 3 steps,
  each loss and gradient norm held to the one-device Trainer's (run here
  before the world) within ``TRAIN_REPLAY_TOL``, its final checkpoint
  (gathered to rank 0 and saved from the mesh) restored onto a (4, 1) mesh
  and onto one device for the next step's loss and gradient norm, every
  step's collectives recorded and equal to ``step_collectives``; (c)
  ``dp_value_and_grad`` on (4, 1) meshes of the card and of the CPU,
  compressed against exact, and the card's compressed mean within one step
  of the largest rank's payload of the CPU's; then (d) a world of one NCCL
  rank: the Trainer of granite-3-8b's reduced config on a (1, 1) mesh for 2
  steps, bit for bit ``mesh=None``; (e) the traced dry run, in processes
  of its own beside (a)-(d): the CLI at granite-3-8b and at
  deepseek-v3-671b, each x train_4k and x decode_32k (each rank's real step
  on fake tensors over a fake 256-rank world on the CPU, a decode step's
  cache split over "model" on its positions: matmul FLOPs, live bytes,
  collectives recorded against the analytic count, no traced field null),
  and the steps whose peak this script measures traced on fake tensors
  (``--traced-peaks``: the ``train`` step, (b)'s, each of (f)'s and (f)'s
  granite decode step), each traced peak held to the card's
  ``max_memory_allocated`` over one step (reset before it) less what the
  process held beside the step's state, within ``PEAK_RATIO``; (f) in the world of
  4, after (b), the other families' mesh step at full width, each layer on
  the rank's "model" shard (``MD_FAMILIES``: deepseek-v3-671b with one dense
  MLA block and the MTP head under Adafactor, mamba2-780m at 2 layers,
  zamba2-7b at one Mamba2 layer and the shared block's one application,
  whisper-tiny whole), 2 steps each, every loss and gradient norm held to
  the one-device Trainer's (run in the parent before the world) within
  ``TRAIN_REPLAY_TOL``, every step's collectives equal to
  ``step_collectives``, the leaves computed on their "model" block named;
  then one mesh decode step of granite-3-8b at 2 layers and of each
  ``MD_FAMILIES`` config in f32, and of granite in bf16
  (``MD_DECODE_RUNS``; ``MD_DECODE``: 4 rows over a cache of 512 positions
  split over "model", random, at position 200, so that the second "model"
  rank holds only masked rows; ``dryrun.make_mesh_decode`` on the rank's
  blocks), its logits held to the one-device ``decode_step`` (run in the
  parent before the world) within ``MD_DECODE_REL`` (1e-3 in f32, 0.1 in
  bf16), its collectives equal to ``forward_collectives(decode=True)``.
  Each rank's peak memory, the step time, collective bytes recorded and
  analytic.

Every profiled sample must hold one kernel event of the port's kernels for
each launch the counters saw (a replayed graph counts the launches it
captured); a sample that loses events is taken again and, failing three
times, reported as null (``main_path.trace_check``).

K5 is held to its plain version bit for bit at every shape, on two calls in
a row (its split-K counters and workspace must come back to zero), the
expert shapes of the moe family as one batched launch too (timed beside the
same products as E separate launches); K6 within
2e-5 in f32 and 3e-2 in bf16; K7 within 2e-5 in f32 and 2^-7 in bf16 at the
served cells' shapes, bit for bit with NaN written past the positions, and
replayed in a CUDA graph with new positions.  The SASS of the tensor-core kernels must hold
HMMA (K6, both types) and IMMA (K5) where the toolkit has ``cuobjdump``.  K3 and
K4 run their cluster path at D = H = 256 (the plan and the card's cluster
occupancy are in their entries) and are held to their plain versions there
too, with a forced batch tile that leaves a ragged last cluster, and at a
batch of 200 whose input projection no longer fits at once (it runs in
chunks of steps); K4 also at four layers.  K2's entry gives its geometry
(units and rows a block, grid); with ``--parent DIR``, a checkout of the
parent commit, the parent's K2 and K6 are built from DIR and timed beside
them (K6 in f32 at the granite shape).

The ``tuner`` phase holds the block-size tuner (``kernels/autotune.py``) to
the card: at every K2-K6 shape of the paths it times the tuner's pick beside
the fixed plan the tuner replaced (passed explicitly), the analytic top 6
and a spread of probes, refines the top 3 by measurement
(``bench.make_measure_fn``) in a cache directory of its own, holds every
output to its plain version, and refits the model's constants to this run's
timings (``tuner.fit``).  The ``chip_model`` phase checks ``H100Chip``
against the card's properties, and ``energy`` reads ``power.draw`` idle and
under a 2 s K3 loop beside ``H100Chip.step_power``.

Lines printed, in order: ``env``, the card, ``build`` (with the SASS check),
``phase`` lines (seconds per phase), ``serve_dense``, ``serve_engine`` (with
the replayed and eager tick times), ``serve_paged``, ``serve_moe``, ``serve_ssm``,
``serve_audio``, ``serve_vlm``, ``duty_cycle``, ``serve_scheduler``, ``train``,
``plan``, ``examples``, ``multi_device``, ``traced_peaks``, ``int8_path_shapes``,
``host_path`` (each kernel wrapper's host time, ``"auto"`` against the same plan passed
explicitly, and K1's host path piece by piece), ``chip_model``, ``tuner``,
``energy``, one JSON object ``{"kernels": [...]}``,
``main_path``, the card as ``nvidia-smi`` names it, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is then
not 0 and the last line is not printed.  ``--out FILE`` also writes the whole
report as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import SHAPES, get_config, get_reduced_config, list_archs  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import constraints as constraints_mod  # noqa: E402
from repro_torch.core import cost_model as cost_mod  # noqa: E402
from repro_torch.core.candidates import DesignPoint  # noqa: E402
from repro_torch.core import generator as generator_mod  # noqa: E402
from repro_torch.core.energy import DEFAULT_CHIP  # noqa: E402
from repro_torch.core.fpga import paper_workload  # noqa: E402
from repro_torch.kernels import bench, ops, runtime  # noqa: E402
from repro_torch.kernels.activations import (  # noqa: E402
    activation, activation_plain, impl_code, table_pointer,
)
from repro_torch.kernels import decode_attention as decode_mod  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention, flash_attention_plain, flash_smem_bytes,
)
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain, plan  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.lstm_cell import lstm_cell_fused, lstm_cell_plain  # noqa: E402
from repro_torch.kernels.lstm_cell import plan as cell_plan  # noqa: E402
from repro_torch.kernels.lstm_quant import quantize_lstm_stack, quantize_lstm_weights  # noqa: E402
from repro_torch.kernels.lstm_seq import (  # noqa: E402
    _lstm_stack_call, cluster_slots, lstm_seq_fused, lstm_seq_fused_quantized, lstm_seq_plain,
    lstm_stack_fused, lstm_stack_plain, plan_launch,
)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch.train import plan_paper_lstm  # noqa: E402
from repro_torch.models.lstm import lstm_apply, lstm_stack_apply  # noqa: E402
from repro_torch.kernels import int8_matmul as int8_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import quant as quant_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import unembed_apply  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params, params_from_numpy, tree_flatten, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.models.quant import QuantTensor, layer_of, quantize_weight  # noqa: E402
from repro_torch.core import tracing  # noqa: E402
from repro_torch.core import workload as workload_mod  # noqa: E402
from repro_torch.data import pipeline as data_mod  # noqa: E402
from repro_torch.serving import draft as draft_mod  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import faults as faults_mod  # noqa: E402
from repro_torch.serving import graphs as graphs_mod  # noqa: E402
from repro_torch.serving import load as load_mod  # noqa: E402
from repro_torch.serving import policy as policy_mod  # noqa: E402
from repro_torch.serving import power as power_mod  # noqa: E402
from repro_torch.serving import scheduler as sched_mod  # noqa: E402
from repro_torch.serving.kv_cache import cache_defs  # noqa: E402
from repro_torch.serving.pages import SCRATCH  # noqa: E402
from repro_torch.training import optimizer as optimizer_mod  # noqa: E402
from repro_torch.training import train_loop as train_loop_mod  # noqa: E402
from repro_torch.training import grad_compress as grad_compress_mod  # noqa: E402
from repro_torch.core import collectives as collectives_mod  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import world as world_mod  # noqa: E402
from repro_torch.sharding import layout as layout_mod  # noqa: E402
from repro_torch.sharding import rules as rules_mod  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# the f32 rate outside the tensor cores, and the dense tensor-core rates of
# TF32, bf16 and int8.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

IMPLS = ("exact", "pwl", "lut", "hard")
PAPER_BATCH = 64
SCALED_SHAPE = (32, 64, 16, 32)            # (B, S, D, H)
QUANT_SHAPE = (40, 28, 256, 256)
STACK_SHAPE = (40, 28, 256, 256, 3)        # (B, S, D, H, L)
RAGGED_BATCH = 33
RAGGED_TILE = 7                            # K3 rows a cluster at QUANT_SHAPE: 5 x 7 + 5
CHUNK_SHAPE = (200, 28, 256, 256)          # K3's projection in chunks: 1 step (f32), 15 (int8)
REQUESTS = 8

# Kernel against plain version, on the card.  f32: the two sum the products
# in another order and the kernel contracts multiply-adds, so they differ in
# the last bits, carried through S steps: 2e-5, absolute and relative, as the
# reference's own kernel tests.  int8 weights: 1e-4, as those tests.
# impl="lut" is discontinuous: a pre-activation that differs in its last bits
# can land in the neighbouring table bin.  One such flip moves a sigmoid by up
# to one table step (0.25 * 8/255 = 7.8e-3) and a tanh, which is 2σ(2x) − 1,
# by up to 1.57e-2; the changed h then enters every gate of its row at the
# next step, so at H = 256 a flip leaves most of the row's later elements a
# little over the f32 tolerance, and a few flips compound.  The share of
# elements over the tolerance is therefore unbounded at these widths; what a
# right kernel does keep small is the mean.  The rule for lut in a recurrence:
# mean error at most 2e-3 and no element above 5e-2 (three tanh steps); a
# wrong table, index or gate order fails both by an order of magnitude.
TOL_F32, TOL_Q8 = 2e-5, 1e-4
LUT_MAX, LUT_MEAN = 5e-2, 2e-3
LUT_SEEN: dict[str, dict] = {}   # worst lut statistics seen, by check


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------
def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def compare(got, want, impl: str, tol: float, what: str, same_inputs: bool = False,
            floor: float | None = None) -> float:
    """Max abs error; fails when the rule for ``impl`` is broken: an error
    over ``floor + tol * |want|`` (``floor`` ``tol`` unless given).  The
    two-part lut rule applies unless both sides feed the table the very same
    numbers (``same_inputs``: the elementwise kernel)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    worst = float(err.max())
    above = err > (tol if floor is None else floor) + tol * want.abs()
    if impl == "lut" and not same_inputs:
        mean, share = float(err.mean()), float(above.float().mean())
        seen = LUT_SEEN.setdefault(what, {"max": 0.0, "mean": 0.0, "share_over_tolerance": 0.0})
        seen.update(max=max(seen["max"], worst), mean=max(seen["mean"], mean),
                    share_over_tolerance=max(seen["share_over_tolerance"], share))
        if worst > LUT_MAX or mean > LUT_MEAN:
            fail(f"{what} [lut]: max err {worst:.3e} (limit {LUT_MAX}), mean {mean:.3e} "
                 f"(limit {LUT_MEAN})")
    elif bool(above.any()):
        fail(f"{what} [{impl}]: max err {worst:.3e} over tolerance {tol}")
    return worst


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of (CUDA-event time of ``reps`` calls) / reps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def time_pair(fn, library, reps: int = 20, rounds: int = 7) -> tuple[float, float]:
    """``time_ms`` of ``fn`` and of ``library`` in alternating rounds, so
    that a drift of the card's clock or of the host's load reaches both."""
    a, b = [], []
    for _ in range(rounds):
        a.append(time_ms(fn, reps=reps, rounds=1))
        b.append(time_ms(library, reps=reps, rounds=1))
    return statistics.median(a), statistics.median(b)


def warm_card(dev, seconds: float = 1.0) -> None:
    """Bring the card's clocks up from idle before anything is timed:
    back-to-back products for about ``seconds``."""
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = a @ a
            a = a / a.abs().amax()
        torch.cuda.synchronize()


# Profiled samples whose trace lost kernel events: taken again, and never
# reported when every try lost some (``device_ms`` returns None then).
TRACE_CHECK = {"samples": 0, "retaken": 0, "dropped": 0}


def port_kernel_events(prof) -> int:
    """Kernel events of the port's own kernels in a trace: every kernel of
    ``csrc/`` lives in namespace ``repro``."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "repro::" in e.key)


def profiled(fn, reps: int = 1, uncounted: int = 0, activities=None):
    """``reps`` calls of ``fn`` under ``torch.profiler``, taken again (up to
    three tries) until the trace holds one kernel event for every launch the
    port's counters saw in the window (a replayed graph counts the launches
    it captured) plus ``uncounted`` a call (a kernel launched past the
    counters).  Returns (profile, wall ms of the window), or None when every
    try lost events or showed no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    TRACE_CHECK["samples"] += 1
    for attempt in range(3):
        torch.cuda.synchronize()
        before = sum(runtime.launch_counts().values())
        with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = sum(runtime.launch_counts().values()) - before + uncounted * reps
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0 and port_kernel_events(prof) == launched:
            TRACE_CHECK["retaken"] += attempt
            return prof, wall_ms
    TRACE_CHECK["retaken"] += 2
    TRACE_CHECK["dropped"] += 1
    return None


def device_ms(fn, reps: int = 10, uncounted: int = 0):
    """GPU-busy time of one call in ms: the device time of every kernel the
    call launches, from the profiler's trace, without the host's share.
    ``None`` if no trace held every launched kernel (``profiled``)."""
    from torch.autograd import DeviceType

    fn()
    sample = profiled(fn, reps=reps, uncounted=uncounted)
    if sample is None:
        return None
    total_us = sum(e.self_device_time_total for e in sample[0].key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / reps / 1e3


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time the card could take, in ms, and which limit sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Operations per activation and per cell update, as the reference's cost
# weights count them (exp + add + div ≈ 12 for an exact sigmoid).
ACT_OPS, CELL_OPS = 12, 4


def lstm_flops(batch, seq, d_in, hidden, layers=1) -> float:
    macs = batch * seq * 4 * hidden * ((d_in + hidden) + (layers - 1) * 2 * hidden)
    return 2.0 * macs + layers * batch * seq * hidden * (5 * ACT_OPS + CELL_OPS)


def make_lstm(seed: int, batch, seq, d_in, hidden, layers, dev):
    """Inputs and weights from a numpy seed; weights std 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, d_in)).astype(np.float32)
    tree = []
    for l in range(layers):
        fan = d_in if l == 0 else hidden
        tree.append({
            "w": (rng.standard_normal((fan, 4 * hidden)) / np.sqrt(fan)).astype(np.float32),
            "u": (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32),
            "b": (rng.standard_normal((4 * hidden,)) * 0.1).astype(np.float32),
        })
    return torch.from_numpy(x).to(dev), params_from_numpy(tree, dev)


def entry(name, source, replaces, shapes):
    """One element of the ``kernels`` line; the first shape is the main
    path's, and its numbers (impl="exact") are the entry's own."""
    main = shapes[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "device_ms": main["device_ms"], "tolerance": main["tolerance"], "shapes": shapes,
    }


def r6(v):
    return None if v is None else float(f"{v:.6g}")


# The tensor-core kernels and the SASS opcode each of their instantiations
# must hold: bf16 and TF32 mma.sync are HMMA, s8 mma.sync is IMMA.
TENSOR_CORE_KERNELS = {"flash_attention_bf16_kernel": "HMMA", "flash_attention_kernel": "HMMA",
                       "int8_matmul_kernel": "IMMA"}


def ptxas_usage(log: str) -> list[dict]:
    """Registers, static shared memory, stack and spills of every
    instantiation of the tensor-core kernels, from ``nvcc -Xptxas -v``."""
    out, cur = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
            cur = {"kernel": name} if any(k in name for k in TENSOR_CORE_KERNELS) else None
            if cur:
                out.append(cur)
            continue
        if cur is None:
            continue
        for key, pattern in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
            found = re.search(pattern, line)
            if found:
                cur[key] = int(found.group(1))
    return out


def sass_tensor_ops() -> dict | None:
    """Per instantiation of the tensor-core kernels, how many HMMA / IMMA
    instructions ``cuobjdump -sass`` finds in the built library; fails when
    one has none.  ``None`` where the toolkit has no ``cuobjdump``."""
    tool = pathlib.Path(runtime._find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    lib = runtime.BUILD_DIR / f"libkernels-{runtime._sources_hash()}.so"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            family = next((k for k in TENSOR_CORE_KERNELS if k in name), None)
            cur = name if family else None
            if cur:
                counts[cur] = {"family": family, "op": TENSOR_CORE_KERNELS[family], "count": 0}
        elif cur and re.search(rf"\b{counts[cur]['op']}\b", line):
            counts[cur]["count"] += 1
    for family in TENSOR_CORE_KERNELS:
        if not any(c["family"] == family for c in counts.values()):
            fail(f"SASS: no instantiation of {family} in {lib.name}")
    for name, c in counts.items():
        if c["count"] == 0:
            fail(f"SASS: {name} holds no {c['op']} instruction")
    return counts


# ---------------------------------------------------------------------------
# Kernel phases: each holds a kernel against its plain version per impl and
# shape, then times kernel, plain version and library at impl="exact".
# ---------------------------------------------------------------------------
def check_activation(dev):
    b, s, _, h = QUANT_SHAPE
    cases = [((b, s, h), torch.float32), ((4096, 4096), torch.float32),
             ((3, 33, 130), torch.float32), ((128, 256), torch.bfloat16)]
    library = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
               "silu": torch.nn.functional.silu,
               "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh")}
    shapes = []
    for shape, dtype in cases:
        gen = torch.Generator().manual_seed(len(shapes))
        x = (torch.randn(shape, generator=gen) * 4.0).to(dtype).to(dev)
        tol = 2e-2 if dtype == torch.bfloat16 else TOL_F32
        errs = {}
        for fn in ("sigmoid", "tanh", "silu", "gelu"):
            for impl in IMPLS:
                got = activation(x, fn=fn, impl=impl)
                want = activation_plain(x, fn=fn, impl=impl)
                errs[f"{fn}/{impl}"] = compare(got, want, impl, tol, f"activation {fn} {shape}",
                                               same_inputs=True)
        torch.cuda.synchronize()
        bound_ms, bound_by = bound(2 * nbytes(x), x.numel() * ACT_OPS)
        ms, library_ms = time_pair(lambda: activation(x, fn="sigmoid", impl="exact"),
                                   lambda: torch.sigmoid(x))
        shapes.append({
            "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(errs.values()), "err_by_impl": {
                impl: r6(max(v for k, v in errs.items() if k.endswith(impl))) for impl in IMPLS},
            "tolerance": tol, "ms": r6(ms),
            "device_ms": r6(device_ms(lambda: activation(x, fn="sigmoid", impl="exact"))),
            "plain_ms": r6(time_ms(lambda: activation_plain(x, fn="sigmoid", impl="exact"))),
            "library_ms": r6(library_ms), "ms_over_library": r6(ms / library_ms),
            # the floor one launch of an elementwise kernel meets, beside K1's own
            "library_device_ms": r6(device_ms(lambda: torch.sigmoid(x))),
            "ms_by_fn_exact": {fn: r6(time_ms(lambda: activation(x, fn=fn, impl="exact"), reps=10,
                                              rounds=3)) for fn in library},
            "library_ms_by_fn": {fn: r6(time_ms(lambda: call(x), reps=10, rounds=3))
                                 for fn, call in library.items()},
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry("activation", "src/repro_torch/csrc/activations.cu",
                 "src/repro/kernels/activations.py:118", shapes)


def parent_entry(parent: pathlib.Path, source: str, entry: str):
    """The C entry point ``entry`` of another checkout's ``csrc/<source>.cu``
    (``--parent DIR``: the parent commit, unpacked with ``git archive`` under
    the git-ignored ``build/``), built alone into a library of its own, so
    that both versions of a kernel are timed in one run on one card."""
    lib_path = runtime.BUILD_DIR / "parent" / f"lib{source}.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([runtime._find_nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(parent / "src" / "repro_torch" / "csrc" / f"{source}.cu")],
                   check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib_path)), entry)
    fn.argtypes, fn.restype = [ctypes.c_char_p, ctypes.c_int], ctypes.c_int
    return fn


def load_parent_flash(parent: pathlib.Path | None, dev):
    """K6 of the parent checkout (``parent_entry``).  Returns
    ``call(q, k, v, causal) -> out`` for f32 inputs, or None without
    ``--parent``; the parent's f32 kernel takes no dynamic shared memory
    (its entry point refuses any count but 0 for f32)."""
    if parent is None:
        return None
    fn = parent_entry(parent, "flash_attention", "repro_flash_attention")
    pack = struct.Struct("14q").pack

    def call(q, k, v, causal):
        b, h, sq, d = q.shape
        out = torch.empty_like(q)
        rc = fn(pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1],
                     sq, k.shape[2], d, int(causal), 0, 0, runtime.stream_handle(dev)), 14)
        if rc:
            fail(f"the parent's flash_attention refused its launch (code {rc})")
        return out

    return call


def load_parent_cell(parent: pathlib.Path | None, dev):
    """K2 of the parent checkout (``parent_entry``), planned by the parent's
    own ``kernels/lstm_cell.py``.  Returns ``call(x, h, c, w, u, b) ->
    (h', c')`` at impl="exact" and ``block_b="auto"``, or None without
    ``--parent``."""
    if parent is None:
        return None
    fn = parent_entry(parent, "lstm_cell", "repro_lstm_cell")
    spec = importlib.util.spec_from_file_location(
        "parent_lstm_cell", parent / "src" / "repro_torch" / "kernels" / "lstm_cell.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    pack = struct.Struct("16q").pack

    def call(x, h, c, w, u, b):
        batch, d_in = x.shape
        geometry = module.plan("auto", batch, d_in, h.shape[1], runtime.CUDA_BACKEND)
        h_new, c_new = torch.empty_like(h), torch.empty_like(c)
        rc = fn(pack(x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(), u.data_ptr(),
                     b.data_ptr(), table_pointer(dev, impl_code("exact")), h_new.data_ptr(),
                     c_new.data_ptr(), batch, d_in, h.shape[1], impl_code("exact"),
                     geometry.rows, geometry.smem_bytes, runtime.stream_handle(dev)), 16)
        if rc:
            fail(f"the parent's lstm_cell refused its launch (code {rc})")
        return h_new, c_new

    return call


def check_cell(dev, parent: pathlib.Path | None = None):
    lw = paper_workload()
    cases = [QUANT_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden), SCALED_SHAPE,
             (RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden)]
    parent_cell = load_parent_cell(parent, dev)
    shapes = []
    for batch, _, d_in, hidden in cases:
        x3, params = make_lstm(10 + len(shapes), batch, 2, d_in, hidden, 1, dev)
        p = params[0]
        x = x3[:, 0].contiguous()
        state = np.random.default_rng(50 + len(shapes)).standard_normal((2, batch, hidden))
        h = torch.tanh(torch.from_numpy(state[0].astype(np.float32))).to(dev)
        c = torch.from_numpy(state[1].astype(np.float32)).to(dev)
        args = (x, h, c, p["w"], p["u"], p["b"])
        errs = {}
        for impl in IMPLS:
            got = lstm_cell_fused(*args, impl=impl)
            want = lstm_cell_plain(*args, impl=impl)
            errs[impl] = max(compare(g, w, impl, TOL_F32, f"lstm_cell {batch, d_in, hidden}") for g, w in zip(got, want))
        # a tile that does not divide the batch
        got = lstm_cell_fused(*args, block_b=5)
        compare(got[0], lstm_cell_plain(*args)[0], "exact", TOL_F32, "lstm_cell block_b=5")
        parent_ms = parent_err = None
        if parent_cell is not None:
            parent_err = max(compare(g, w, "exact", TOL_F32, f"parent lstm_cell {batch, d_in, hidden}")
                             for g, w in zip(parent_cell(*args), lstm_cell_plain(*args)))
            parent_ms = device_ms(lambda: parent_cell(*args), uncounted=1)
        torch.cuda.synchronize()
        cell = torch.nn.LSTMCell(d_in, hidden, device=dev)
        with torch.no_grad():
            cell.weight_ih.copy_(p["w"].t()); cell.weight_hh.copy_(p["u"].t())
            cell.bias_ih.copy_(p["b"]); cell.bias_hh.zero_()
            lib_err = float((cell(x, (h, c))[0] - got[0]).abs().max())
            library_ms = time_ms(lambda: cell(x, (h, c)))
        out_bytes = 2 * nbytes(h)
        bound_ms, bound_by = bound(nbytes(*args) + out_bytes,
                                   lstm_flops(batch, 1, d_in, hidden))
        geometry = cell_plan("auto", batch, d_in, hidden)
        dev_ms = device_ms(lambda: lstm_cell_fused(*args))
        shapes.append({
            "shape": [batch, d_in, hidden], "units": geometry.units, "rows": geometry.rows,
            "grid": list(geometry.grid), "smem_bytes": geometry.smem_bytes,
            "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": TOL_F32,
            "ms": r6(time_ms(lambda: lstm_cell_fused(*args))), "device_ms": r6(dev_ms),
            "parent_device_ms": r6(parent_ms), "parent_max_abs_err": r6(parent_err),
            "device_ms_over_parent": r6(None if parent_ms is None or dev_ms is None
                                        else dev_ms / parent_ms),
            "plain_ms": r6(time_ms(lambda: lstm_cell_plain(*args))),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    return entry("lstm_cell", "src/repro_torch/csrc/lstm_cell.cu",
                 "src/repro/kernels/lstm_cell.py:82", shapes)


def check_seq(dev, quantized: bool):
    lw = paper_workload()
    cases = [QUANT_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden), SCALED_SHAPE,
             (RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden)]
    tol = TOL_Q8 if quantized else TOL_F32
    name = "lstm_seq_q8" if quantized else "lstm_seq_f32"
    shapes = []
    for batch, seq, d_in, hidden in cases:
        x, params = make_lstm(20 + len(shapes), batch, seq, d_in, hidden, 1, dev)
        p = params[0]
        if quantized:
            qw = quantize_lstm_weights(p["w"], p["u"], p["b"], hidden)
            operands = (qw.w_q, qw.u_q, qw.b, qw.w_scale, qw.u_scale)
            kernel = lambda impl="exact", **kw: lstm_seq_fused_quantized(x, qw, impl=impl, **kw)
        else:
            operands = (p["w"], p["u"], p["b"], None, None)
            kernel = lambda impl="exact", **kw: lstm_seq_fused(x, p["w"], p["u"], p["b"],
                                                                impl=impl, **kw)
        errs = {}
        for impl in IMPLS:
            hs, (hn, cn) = kernel(impl, return_state=True)
            want = lstm_seq_plain(x, *operands, impl=impl, packed=quantized)
            errs[impl] = max(compare(g, w, impl, tol, f"{name} {batch, seq, d_in, hidden}")
                             for g, w in zip((hs, hn, cn), want))
        hs5 = kernel(block_b=5)  # a tile that does not divide the batch
        compare(hs5, lstm_seq_plain(x, *operands, packed=quantized)[0], "exact", tol,
                f"{name} block_b=5")
        slots = cluster_slots(dev)
        forced = chunked = None
        if (batch, seq, d_in, hidden) == QUANT_SHAPE:  # 7 rows a cluster: 5 x 7 + 5
            forced = plan_launch(RAGGED_TILE, batch, seq, d_in, hidden, quantized=quantized,
                                 slots=slots)
            if forced.path != "cluster" or forced.block_b != RAGGED_TILE:
                fail(f"{name}: block_b={RAGGED_TILE} planned {forced}, not {RAGGED_TILE} rows "
                     "a cluster")
            for impl in IMPLS:
                hs, (hn, cn) = kernel(impl, block_b=RAGGED_TILE, return_state=True)
                want = lstm_seq_plain(x, *operands, impl=impl, packed=quantized)
                errs[f"{impl}/block_b={RAGGED_TILE}"] = max(
                    compare(g, w, impl, tol, f"{name} block_b={RAGGED_TILE}")
                    for g, w in zip((hs, hn, cn), want))
            chunked, chunk_errs = check_seq_chunked(dev, quantized, tol)
            errs.update(chunk_errs)
        torch.cuda.synchronize()
        library_ms = lib_err = None
        if not quantized:
            lstm = torch.nn.LSTM(d_in, hidden, batch_first=True, device=dev)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(p["w"].t()); lstm.weight_hh_l0.copy_(p["u"].t())
                lstm.bias_ih_l0.copy_(p["b"]); lstm.bias_hh_l0.zero_()
                lib_err = float((lstm(x)[0] - kernel()).abs().max())
                library_ms = time_ms(lambda: lstm(x))
        plan = plan_launch("auto", batch, seq, d_in, hidden, quantized=quantized, slots=slots)
        weights = [t for t in operands if t is not None]
        out_bytes = 4 * (batch * seq * hidden + 2 * batch * hidden)
        bound_ms, bound_by = bound(nbytes(x, *weights) + out_bytes,
                                   lstm_flops(batch, seq, d_in, hidden))
        dev_ms = device_ms(kernel)
        shapes.append({
            "shape": [batch, seq, d_in, hidden], **seq_plan(plan, quantized),
            "forced_ragged_plan": None if forced is None else seq_plan(forced, quantized),
            "chunked_plan": chunked,
            "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": tol,
            "ms": r6(time_ms(kernel)), "device_ms": r6(dev_ms),
            "device_ms_per_step": r6(None if dev_ms is None else dev_ms / seq),
            "ms_by_impl": {impl: r6(time_ms(lambda: kernel(impl), reps=10, rounds=3))
                           for impl in IMPLS},
            "plain_ms": r6(time_ms(lambda: lstm_seq_plain(x, *operands, packed=quantized),
                                   reps=3, rounds=3)),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    out = entry(name, "src/repro_torch/csrc/lstm_seq.cu",
                "src/repro/kernels/lstm_seq.py:245", shapes)
    out["plan"] = {k: shapes[0][k] for k in ("path", "block_b", "cluster", "clusters", "chunk",
                                             "smem_bytes", "resident", "cluster_occupancy")}
    return out


def check_seq_chunked(dev, quantized: bool, tol: float):
    """K3 at ``CHUNK_SHAPE``, where the auto plan's input projection runs in
    chunks of steps (a chunk shorter than S, re-projected at every chunk's
    first step), held to its plain version at every impl."""
    batch, seq, d_in, hidden = CHUNK_SHAPE
    name = "lstm_seq_q8" if quantized else "lstm_seq_f32"
    plan = plan_launch("auto", batch, seq, d_in, hidden, quantized=quantized,
                       slots=cluster_slots(dev))
    if plan.path != "cluster" or plan.chunk >= seq:
        fail(f"{name} {CHUNK_SHAPE}: planned {plan}, not a cluster plan in chunks")
    x, params = make_lstm(29, batch, seq, d_in, hidden, 1, dev)
    p = params[0]
    if quantized:
        qw = quantize_lstm_weights(p["w"], p["u"], p["b"], hidden)
        operands = (qw.w_q, qw.u_q, qw.b, qw.w_scale, qw.u_scale)
        kernel = lambda impl: lstm_seq_fused_quantized(x, qw, impl=impl, return_state=True)
    else:
        operands = (p["w"], p["u"], p["b"], None, None)
        kernel = lambda impl: lstm_seq_fused(x, p["w"], p["u"], p["b"], impl=impl,
                                             return_state=True)
    errs = {}
    for impl in IMPLS:
        hs, (hn, cn) = kernel(impl)
        want = lstm_seq_plain(x, *operands, impl=impl, packed=quantized)
        errs[f"{impl}/{CHUNK_SHAPE}"] = max(
            compare(g, w, impl, tol, f"{name} {CHUNK_SHAPE} chunk={plan.chunk}")
            for g, w in zip((hs, hn, cn), want))
    return {"shape": list(CHUNK_SHAPE), **seq_plan(plan, quantized)}, errs


def seq_plan(plan, quantized: bool) -> dict:
    """A K3 or K4 launch plan as the kernels line reports it, with the number of
    its clusters the card holds at once (cudaOccupancyMaxActiveClusters)
    where it is a cluster plan."""
    occupancy = None
    if plan.path == "cluster":
        occupancy = runtime.query("repro_lstm_seq_cluster_occupancy", int(quantized),
                                  plan.block_b, plan.smem_bytes)
        if occupancy < 0:
            fail(f"cudaOccupancyMaxActiveClusters failed (CUDA error {-occupancy}) for {plan}")
    return {"path": plan.path, "block_b": plan.block_b, "cluster": plan.cluster,
            "clusters": plan.clusters, "chunk": plan.chunk, "smem_bytes": plan.smem_bytes,
            "resident": plan.resident, "cluster_occupancy": occupancy}


def stack_operands(params, quantized: bool):
    """The stack kernel's operands, a ``(w, u, b, sw, su)`` tuple a layer, as
    ``lstm_stack_fused`` builds them."""
    if quantized:
        return [(q.w_q, q.u_q, q.b, q.w_scale, q.u_scale) for q in quantize_lstm_stack(params)]
    return [(p["w"], p["u"], p["b"], None, None) for p in params]


def stack_kernel(x, operands, quantized: bool, block_b="auto"):
    """K4's wrapper on the kernel's own operands, impl="exact": int8 weights
    quantized once, as a deployment holds them (``lstm_stack_fused`` with
    ``quantized=True`` quantizes them again on every call)."""
    return _lstm_stack_call(x, operands, impl="exact", block_b=block_b, return_state=False,
                            packed=quantized)


def check_stack_case(dev, quantized: bool, shape, seed: int, block_b="auto", want_path=None,
                     chunked: bool = False) -> dict:
    """K4 at one (B, S, D, H, L) and ``block_b``, held to its plain version at
    every impl; its plan (and the card's occupancy for a cluster plan) and
    device time.  Fails if the plan is not ``want_path`` or, for
    ``chunked``, holds the whole projection at once."""
    batch, seq, d_in, hidden, layers = shape
    tol = TOL_Q8 if quantized else TOL_F32
    name = "lstm_stack_q8" if quantized else "lstm_stack_f32"
    plan = plan_launch(block_b, batch, seq, d_in, hidden, layers=layers, quantized=quantized,
                       slots=cluster_slots(dev))
    if (want_path and plan.path != want_path) or (chunked and plan.chunk >= seq):
        fail(f"{name} {shape} block_b={block_b}: planned {plan}")
    x, params = make_lstm(seed, batch, seq, d_in, hidden, layers, dev)
    operands = stack_operands(params, quantized)
    errs = {}
    for impl in IMPLS:
        hs, (hn, cn) = lstm_stack_fused(x, params, impl=impl, quantized=quantized,
                                        block_b=block_b, return_state=True)
        want = lstm_stack_plain(x, operands, impl=impl, packed=quantized)
        errs[impl] = max(compare(g, w, impl, tol, f"{name} {shape} block_b={block_b}")
                         for g, w in zip((hs, hn, cn), want))
    dev_ms = device_ms(lambda: stack_kernel(x, operands, quantized, block_b))
    return {"shape": list(shape), "requested_block_b": block_b, **seq_plan(plan, quantized),
            "max_abs_err": max(errs.values()), "err_by_impl": {k: r6(v) for k, v in errs.items()},
            "device_ms": r6(dev_ms),
            "device_ms_per_layer_step": r6(None if dev_ms is None else dev_ms / (seq * layers))}


# K4's cases on the cluster path beside its main shape: a forced tile that
# leaves a ragged last cluster (40 = 13 x 3 + 1), a batch whose projection
# runs in chunks of steps, and four layers at an odd S (the inter-layer
# buffers are reused two layers apart, and each mbarrier's phase count per
# layer is uneven)
STACK_RAGGED_TILE = 3
STACK_CHUNK_SHAPE = (200, 28, 256, 256, 3)
STACK_DEEP_SHAPE = (6, 11, 256, 256, 4)


def check_stack(dev, quantized: bool):
    lw = paper_workload()
    cases = [STACK_SHAPE, (PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, 3),
             (RAGGED_BATCH, SCALED_SHAPE[1], SCALED_SHAPE[2], SCALED_SHAPE[3], 2)]
    tol = TOL_Q8 if quantized else TOL_F32
    name = "lstm_stack_q8" if quantized else "lstm_stack_f32"
    shapes = []
    for batch, seq, d_in, hidden, layers in cases:
        x, params = make_lstm(30 + len(shapes), batch, seq, d_in, hidden, layers, dev)
        operands = stack_operands(params, quantized)
        kernel = lambda impl="exact", **kw: lstm_stack_fused(x, params, impl=impl,
                                                              quantized=quantized, **kw)
        errs = {}
        for impl in IMPLS:
            hs, (hn, cn) = kernel(impl, return_state=True)
            want = lstm_stack_plain(x, operands, impl=impl, packed=quantized)
            errs[impl] = max(compare(g, w, impl, tol, f"{name} {batch, seq, d_in, hidden, layers}")
                             for g, w in zip((hs, hn, cn), want))
        hs3 = kernel(block_b=3)  # a tile that does not divide the batch
        compare(hs3, lstm_stack_plain(x, operands, packed=quantized)[0], "exact", tol,
                f"{name} block_b=3")
        more = []
        if (batch, seq, d_in, hidden, layers) == STACK_SHAPE:
            more = [check_stack_case(dev, quantized, STACK_SHAPE, 36, STACK_RAGGED_TILE,
                                     "cluster"),
                    check_stack_case(dev, quantized, STACK_CHUNK_SHAPE, 37, want_path="cluster",
                                     chunked=True),
                    check_stack_case(dev, quantized, STACK_DEEP_SHAPE, 38, want_path="cluster")]
            for case in more:
                errs[f"{case['requested_block_b']}/{tuple(case['shape'])}"] = case["max_abs_err"]
        torch.cuda.synchronize()
        library_ms = lib_err = None
        if not quantized:
            lstm = torch.nn.LSTM(d_in, hidden, num_layers=layers, batch_first=True, device=dev)
            with torch.no_grad():
                for l, p in enumerate(params):
                    getattr(lstm, f"weight_ih_l{l}").copy_(p["w"].t())
                    getattr(lstm, f"weight_hh_l{l}").copy_(p["u"].t())
                    getattr(lstm, f"bias_ih_l{l}").copy_(p["b"])
                    getattr(lstm, f"bias_hh_l{l}").zero_()
                lib_err = float((lstm(x)[0] - kernel()).abs().max())
                library_ms = time_ms(lambda: lstm(x))
        plan = plan_launch("auto", batch, seq, d_in, hidden, layers=layers, quantized=quantized,
                           slots=cluster_slots(dev))
        weights = [t for op in operands for t in op if t is not None]
        out_bytes = 4 * (batch * seq * hidden + 2 * layers * batch * hidden)
        bound_ms, bound_by = bound(nbytes(x, *weights) + out_bytes,
                                   lstm_flops(batch, seq, d_in, hidden, layers))
        timed = lambda: stack_kernel(x, operands, quantized)  # noqa: E731
        compare(timed(), lstm_stack_plain(x, operands, packed=quantized)[0], "exact", tol,
                f"{name} {batch, seq, d_in, hidden, layers} on its own operands")
        dev_ms = device_ms(timed)
        shapes.append({
            "shape": [batch, seq, d_in, hidden, layers], **seq_plan(plan, quantized),
            "more_cases": more or None, "max_abs_err": max(errs.values()),
            "err_by_impl": {k: r6(v) for k, v in errs.items()}, "tolerance": tol,
            "ms": r6(time_ms(timed)), "device_ms": r6(dev_ms),
            "device_ms_quantizing_per_call": r6(device_ms(kernel)) if quantized else None,
            "device_ms_per_layer_step": r6(None if dev_ms is None else dev_ms / (seq * layers)),
            "plain_ms": r6(time_ms(lambda: lstm_stack_plain(x, operands, packed=quantized),
                                   reps=2, rounds=3)),
            "library_ms": r6(library_ms), "library_max_abs_diff": r6(lib_err),
            "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    out = entry(name, "src/repro_torch/csrc/lstm_seq.cu",
                "src/repro/kernels/lstm_seq.py:368", shapes)
    out["plan"] = {k: shapes[0][k] for k in ("path", "block_b", "cluster", "clusters", "chunk",
                                             "smem_bytes", "resident", "cluster_occupancy")}
    return out


# ---------------------------------------------------------------------------
# The host path every wrapper shares
# ---------------------------------------------------------------------------
HOST_CALLS = 10_000   # calls per host-clock sample of the K1 split


def host_ns(fn, calls: int = HOST_CALLS) -> float:
    """Host nanoseconds per call of ``fn`` over ``calls`` calls in a loop
    (perf_counter_ns), after a warm-up; the card is synchronised around the
    loop, not inside it."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return elapsed / calls


def host_path(dev) -> dict:
    """Host time of each kernel wrapper at its smallest shape of this script:
    ``ms`` (CUDA events over a loop of calls: at these shapes the host's
    issue rate sets it) minus ``device_ms``; K2 also at its main-path shape.
    Then K1's host path at 40x28x256 f32 piece by piece, each piece timed
    alone by the host clock, beside ``torch.sigmoid`` on the same tensor."""
    lw = paper_workload()
    _, paper = make_lstm(60, 1, 1, lw.d_in, lw.hidden, 1, dev)
    p = paper[0]
    xs, _ = make_lstm(61, RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden, 1, dev)
    xc = xs[:, 0].contiguous()
    hc = torch.zeros((RAGGED_BATCH, lw.hidden), device=dev)
    xk, stack = make_lstm(62, PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, 3, dev)
    b, s, _, h = QUANT_SHAPE
    x2, big = make_lstm(63, b, 1, h, h, 1, dev)
    x2 = x2[:, 0].contiguous()
    h2 = torch.zeros((b, h), device=dev)
    xq, wq, sx, sw = int8_operands(*INT8_TEST_SHAPES[2], dev, 64)
    fb, fh, fkv, fsq, fsk, fd = 1, 6, 3, 45, 77, 16
    gen = torch.Generator(device=dev).manual_seed(65)
    q = torch.randn((fb, fh, fsq, fd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((fb, fkv, fsk, fd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((fb, fkv, fsk, fd), generator=gen, device=dev).to(torch.bfloat16)
    xa = torch.randn((3, 33, 130), generator=gen, device=dev)
    wrappers = {
        "activation (3, 33, 130) f32": lambda: activation(xa),
        f"lstm_cell ({RAGGED_BATCH}, {lw.d_in}, {lw.hidden})":
            lambda: lstm_cell_fused(xc, hc, hc, p["w"], p["u"], p["b"]),
        f"lstm_cell {QUANT_SHAPE[0], QUANT_SHAPE[2], QUANT_SHAPE[3]} (main path)":
            lambda: lstm_cell_fused(x2, h2, h2, big[0]["w"], big[0]["u"], big[0]["b"]),
        f"lstm_seq ({RAGGED_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}) f32":
            lambda: lstm_seq_fused(xs, p["w"], p["u"], p["b"]),
        f"lstm_stack ({PAPER_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}, 3) f32":
            lambda: lstm_stack_fused(xk, stack),
        f"int8_matmul {INT8_TEST_SHAPES[2]}": lambda: int8_matmul(xq, wq, sx, sw),
        f"flash_attention {(fb, fh, fkv, fsq, fsk, fd)} bf16":
            lambda: flash_attention(q, k, v, causal=True),
    }
    per_wrapper = {}
    for name, fn in wrappers.items():
        ms, dms = time_ms(fn, reps=50), device_ms(fn)
        per_wrapper[name] = {"ms": r6(ms), "device_ms": r6(dms),
                             "host_us": r6(None if dms is None else (ms - dms) * 1e3),
                             "host_call_us": r6(host_ns(fn, 2000) / 1e3)}
    out = {"wrappers": per_wrapper}
    # "auto" (the tuner's pick, memoized per shape) against the same plan
    # passed explicitly: the host time the tuner adds to a call
    k3 = plan_launch("auto", RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden, slots=cluster_slots(dev),
                     backend=runtime.CUDA_BACKEND)
    k5 = plan(*INT8_TEST_SHAPES[2], "auto", "auto", "auto", runtime.CUDA_BACKEND)
    pairs = {
        f"lstm_seq ({RAGGED_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}) f32": (
            lambda: lstm_seq_fused(xs, p["w"], p["u"], p["b"]),
            lambda: lstm_seq_fused(xs, p["w"], p["u"], p["b"], block_b=k3.block_b)),
        f"int8_matmul {INT8_TEST_SHAPES[2]}": (
            lambda: int8_matmul(xq, wq, sx, sw),
            lambda: int8_matmul(xq, wq, sx, sw, block_m=k5.block_m, block_n=k5.block_n,
                                block_k=k5.k_chunk)),
    }
    plans = {  # the plan lookup alone: what "auto" can add to a call
        f"lstm_seq ({RAGGED_BATCH}, {lw.seq}, {lw.d_in}, {lw.hidden}) f32": (
            lambda: plan_launch("auto", RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden,
                                slots=cluster_slots(dev), backend=runtime.CUDA_BACKEND),
            lambda: plan_launch(k3.block_b, RAGGED_BATCH, lw.seq, lw.d_in, lw.hidden,
                                slots=cluster_slots(dev), backend=runtime.CUDA_BACKEND)),
        f"int8_matmul {INT8_TEST_SHAPES[2]}": (
            lambda: plan(*INT8_TEST_SHAPES[2], "auto", "auto", "auto", runtime.CUDA_BACKEND),
            lambda: plan(*INT8_TEST_SHAPES[2], k5.block_m, k5.block_n, k5.k_chunk,
                         runtime.CUDA_BACKEND)),
    }
    auto_vs = {}
    for name, (auto, explicit) in pairs.items():
        t = {"auto": [], "explicit": []}
        for _ in range(20):  # in turns; the best of twenty samples of each
            t["auto"].append(host_ns(auto, 500) / 1e3)
            t["explicit"].append(host_ns(explicit, 500) / 1e3)
        auto_us, explicit_us = min(t["auto"]), min(t["explicit"])
        lookup = {side: host_ns(fn, 20000) / 1e3 for side, fn in zip(("auto", "explicit"),
                                                                     plans[name])}
        auto_vs[name] = {"auto_call_us": r6(auto_us), "explicit_call_us": r6(explicit_us),
                         "auto_minus_explicit_us": r6(auto_us - explicit_us),
                         "plan_lookup_us": {k: r6(v) for k, v in lookup.items()}}
    out["auto_vs_explicit"] = auto_vs
    x = torch.randn(QUANT_SHAPE[:2] + QUANT_SHAPE[3:], device=dev)
    y = torch.empty_like(x)
    runtime.load_kernels()
    fn, pack, count = runtime._entries["repro_activation"]
    xp, yp, n = x.data_ptr(), y.data_ptr(), x.numel()
    raw, get_device = runtime._raw_stream, runtime._get_device
    pieces = {
        "wrapper": lambda: activation(x),
        "torch.sigmoid": lambda: torch.sigmoid(x),
        "torch.empty_like": lambda: torch.empty_like(x),
        "runtime.launch": lambda: runtime.launch("host_path", "repro_activation", 0, xp, yp, n,
                                                 0, 0, 0, 0),
        "pack + ctypes + C entry, no launch": lambda: fn(pack(xp, yp, 0, 0, 0, 0, 0, 0), count),
        "pack + ctypes + C entry + cudaLaunchKernel":
            lambda: fn(pack(xp, yp, n, 0, 0, 0, 0, raw(0)), count),
        "raw stream handle": lambda: raw(0),
        "current device": lambda: get_device(),
        "x.data_ptr()": lambda: x.data_ptr(),
        "x.is_contiguous()": lambda: x.is_contiguous(),
        "torch.cuda.current_stream().cuda_stream (the previous launch path)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_device() (the previous launch path)": lambda: torch.cuda.current_device(),
    }
    split = {}
    for _ in range(2):  # the better of two samples of each piece
        for name, piece in pieces.items():
            t = host_ns(piece)
            split[name] = t if name not in split else min(split[name], t)
    split = {name: r6(t / 1e3) for name, t in split.items()}
    split["the wrapper's own Python (wrapper - empty_like - launch)"] = r6(
        split["wrapper"] - split["torch.empty_like"] - split["runtime.launch"])
    out["k1_split_us"] = split
    k1_ms, k1_library_ms = time_pair(lambda: activation(x), lambda: torch.sigmoid(x), reps=50)
    out.update(k1_ms=r6(k1_ms), k1_library_ms=r6(k1_library_ms),
               k1_over_library=r6(k1_ms / k1_library_ms))
    return out


# ---------------------------------------------------------------------------
# K5 int8_matmul and K6 flash_attention: kernel against plain version
# ---------------------------------------------------------------------------
GRANITE = "granite-3-8b"
SERVE_LAYERS = 8                    # the only cut of granite-3-8b: 40 → 8 layers
# (M, K, N): the reference's kernel tests, then every projection of the
# serving path at decode (M = 4 slots), a 64-token prefill and 4 x 64 tokens
INT8_TEST_SHAPES = [(64, 128, 64), (128, 256, 128), (32, 64, 96)]
INT8_PROJ_KN = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096)]
INT8_MAIN = (4, 4096, 12800)        # the entry's own numbers: wg/wu at decode
# a ragged shape, and a split-K stress shape (ragged K and N, 17 chunks of K)
INT8_SHAPES = ([INT8_MAIN] + [(m, k, n) for m in (4, 64, 256) for k, n in INT8_PROJ_KN
                              if (m, k, n) != INT8_MAIN]
               + INT8_TEST_SHAPES + [(33, 4100, 1030), (4, 12803, 1030)])
# (B, H, KV, Sq, Sk, D, causal, dtype): granite-shaped causal attention over
# 2048 tokens, the reference's kernel tests in f32 and their bf16 twins (every
# head width, MQA non-causal, ragged 45 x 77), the reference's bf16 case, and
# a ragged non-causal case at the granite head width
_FLASH_TESTS = [(1, 4, 4, 128, 128, 32, True), (2, 8, 2, 128, 128, 64, True),
                (1, 4, 1, 64, 256, 32, False), (2, 2, 2, 256, 256, 16, True),
                (1, 6, 3, 45, 77, 16, True)]
FLASH_MAIN = (1, 32, 8, 2048, 2048, 128, True, torch.bfloat16)
FLASH_SHAPES = ([FLASH_MAIN, (1, 32, 8, 2048, 2048, 128, True, torch.float32)]
                + [(*c, torch.float32) for c in _FLASH_TESTS]
                + [(*c, torch.bfloat16) for c in _FLASH_TESTS]
                + [(1, 4, 2, 128, 128, 32, True, torch.bfloat16),
                   (1, 6, 3, 45, 77, 128, False, torch.bfloat16)])
# bf16 kernel against its plain version: the reference's bf16 flash
# tolerance, 3e-2.  Both round p to bf16 before p @ v and the output to bf16;
# they differ in the order of the f32 sums and in exp (exp2f(x log2 e) on the
# card), which can move p or an output across a bf16 rounding edge: one unit
# of 2^-8 relative, 3.9e-3 at |out| ~ 1 (seen on an H100).
TOL_BF16 = 3e-2


def int8_operands(m, k, n, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    xq, sx = ops.quantize_rowwise(x)
    wq, sw = ops.quantize_colwise(w)
    return xq, wq, sx, sw


COLD_BYTES = 128 << 20  # weight copies cycled by cold_device_ms: over twice the 50 MB L2


def cold_device_ms(fn, wq):
    """Device time of one ``fn(w)`` over a ring of copies of ``wq`` whose
    bytes exceed the L2 cache, so that every call reads its weight from
    device memory, as the serving path does (its 1.6 GB of projections never
    fit L2).  ``device_ms`` of one weight in a loop finds it in L2 when it is
    smaller than 50 MB.  Device time, not CUDA-event time: back-to-back
    wrapper calls at decode are bound by the host."""
    copies = [wq] + [wq.clone() for _ in range(-(-COLD_BYTES // wq.numel()) - 1)]
    turn = iter(range(10**9))
    t = device_ms(lambda: fn(copies[next(turn) % len(copies)]), reps=len(copies))
    del copies
    return t


def int8_library_ok(m, k, n) -> bool:
    """torch._int_mm's shape rules on CUDA: more than 16 rows, K and N
    multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


# (E, M, K, N, x shared by every product): the expert einsums of the MoE
# dense path, one launch over the expert axis.  granite-moe-3b-a800m at
# decode (M = 4 slots) and at a 4 x 64-token prefill, wg/wu (1536 x 512, the
# token block shared by the 48 experts, quantized once) and wd (512 x 1536,
# each expert's own rows); deepseek-v3 at decode, 256 experts of 7168 x 2048
# and 2048 x 7168.
INT8_BATCHED = [(48, 4, 1536, 512, True), (48, 4, 512, 1536, False),
                (48, 256, 1536, 512, True), (48, 256, 512, 1536, False),
                (256, 4, 7168, 2048, True), (256, 4, 2048, 7168, False)]


def batched_int8_operands(e, m, k, n, dev, seed, shared: bool):
    """E products' operands on the card, each weight quantized per expert;
    x is one product's expanded over the batch (stride 0) when ``shared``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(((1 if shared else e) * m, k), generator=gen, device=dev)
    xq, sx = ops.quantize_rowwise(x)
    xq, sx = xq.reshape(-1, m, k).expand(e, m, k), sx.reshape(-1, m, 1).expand(e, m, 1)
    wq = torch.empty((e, k, n), dtype=torch.int8, device=dev)
    sw = torch.empty((e, n), dtype=torch.float32, device=dev)
    for i in range(e):
        wq[i], sw[i] = ops.quantize_colwise(torch.randn((k, n), generator=gen, device=dev))
    return xq, wq, sx, sw


def check_int8_batched(dev, i: int, e: int, m: int, k: int, n: int, shared: bool) -> dict:
    """One batched shape: the kernel bit for bit against its plain version
    on two calls in a row (the split-K workspace of every product back at
    zero) and against E separate 2-D launches of the same kernel, and the
    device time of both with the weights read from device memory."""
    xq, wq, sx, sw = batched_int8_operands(e, m, k, n, dev, 400 + i, shared)
    got = int8_matmul(xq, wq, sx, sw)
    again = int8_matmul(xq, wq, sx, sw)
    want = int8_matmul_plain(xq, wq, sx, sw)
    torch.cuda.synchronize()
    separate = lambda w: [int8_matmul(xq[j], w[j], sx[j], sw[j]) for j in range(e)]  # noqa: E731
    one_by_one = torch.stack(separate(wq))
    for name, out in (("first call", got), ("second call", again),
                      ("E separate launches", one_by_one)):
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            fail(f"int8_matmul batch {(e, m, k, n)} {name}: not bit-identical to its plain "
                 f"version, max err {float((out - want).abs().max()):.3e}")
    del got, again, want, one_by_one
    x_bytes = (1 if shared else e) * m * k + 4 * (1 if shared else e) * m
    bound_ms, bound_by = bound(wq.numel() + 4 * sw.numel() + x_bytes + 4 * e * m * n,
                               2.0 * e * m * k * n, PEAK_INT8_OPS)
    out = {
        "shape": [m, k, n], "batch": e, "x_shared": shared, "max_abs_err": 0.0,
        "tolerance": 0.0,
        "plan": list(plan(m, k, n, "auto", "auto", "auto", runtime.CUDA_BACKEND, e)),
        "plan_of_one_product": list(plan(m, k, n, "auto", "auto", "auto",
                                         runtime.CUDA_BACKEND)),
        "ms": r6(time_ms(lambda: int8_matmul(xq, wq, sx, sw), reps=5, rounds=3)),
        "device_ms": r6(cold_device_ms(lambda w: int8_matmul(xq, w, sx, sw), wq)),
        "separate_launches_device_ms": r6(cold_device_ms(separate, wq)),
        "plain_ms": r6(time_ms(lambda: int8_matmul_plain(xq, wq, sx, sw), reps=2, rounds=3)),
        "library_ms": None, "bound_ms": r6(bound_ms), "bound_by": bound_by}
    del xq, wq, sx, sw
    torch.cuda.empty_cache()
    return out


def check_int8_matmul(dev):
    shapes = []
    for i, (m, k, n) in enumerate(INT8_SHAPES):
        xq, wq, sx, sw = int8_operands(m, k, n, dev, 100 + i)
        got = int8_matmul(xq, wq, sx, sw)
        again = int8_matmul(xq, wq, sx, sw)  # split-K counters and workspace were reset
        want = int8_matmul_plain(xq, wq, sx, sw)
        torch.cuda.synchronize()
        for name, out in (("first call", got), ("second call", again)):
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                fail(f"int8_matmul {(m, k, n)} {name}: not bit-identical to its plain version, "
                     f"max err {float((out - want).abs().max()):.3e}")
        library = lambda: (torch._int_mm(xq, wq).float() * sx) * sw[None, :]  # noqa: E731
        library_ms = time_ms(library) if int8_library_ok(m, k, n) else None
        bound_ms, bound_by = bound(nbytes(xq, wq, sx, sw) + 4 * m * n, 2.0 * m * k * n,
                                   PEAK_INT8_OPS)
        shapes.append({
            "shape": [m, k, n], "max_abs_err": 0.0,
            "plan": list(plan(m, k, n, "auto", "auto", "auto", runtime.CUDA_BACKEND)),
            "tolerance": 0.0,
            "ms": r6(time_ms(lambda: int8_matmul(xq, wq, sx, sw))),
            "cold_device_ms": r6(cold_device_ms(lambda w: int8_matmul(xq, w, sx, sw), wq)
                                 if (k, n) in INT8_PROJ_KN else None),
            "device_ms": r6(device_ms(lambda: int8_matmul(xq, wq, sx, sw))),
            "plain_ms": r6(time_ms(lambda: int8_matmul_plain(xq, wq, sx, sw), reps=5, rounds=3)),
            "library_ms": r6(library_ms), "bound_ms": r6(bound_ms), "bound_by": bound_by,
        })
    # no PyTorch call computes a batch of int8 products with these scales
    # (torch._int_mm takes one 2-D product of more than 16 rows)
    shapes += [check_int8_batched(dev, i, *case) for i, case in enumerate(INT8_BATCHED)]
    return entry("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
                 "src/repro/kernels/int8_matmul.py:62", shapes)


@contextlib.contextmanager
def k5_shapes_recorded(seen: dict, path: str):
    """Within, every int8_matmul call the model code makes on the card
    (``qeinsum``, eager or while a CUDA graph is captured) records its
    shape in ``seen``: (E, M, K, N, x shared) → the paths that launched it,
    E = 0 for one 2-D product."""
    real = quant_mod.int8_matmul

    def recorded(xq, wq, sx, sw, **kw):
        if xq.is_cuda:
            e = xq.shape[0] if xq.dim() == 3 else 0
            shared = int(e > 1 and xq.stride(0) == 0)
            seen.setdefault((e, *xq.shape[-2:], wq.shape[-1], shared), set()).add(path)
        return real(xq, wq, sx, sw, **kw)

    quant_mod.int8_matmul = recorded
    try:
        yield
    finally:
        quant_mod.int8_matmul = real


def check_int8_path_shapes(dev, seen: dict) -> dict:
    """K5 at every shape the serving paths launched it at (``seen``, from
    :func:`k5_shapes_recorded`), bit for bit against its plain version on
    two calls in a row, from int8 operands over the whole range and random
    positive scales, x shared by the batch where the path shared it."""
    checked = []
    for i, key in enumerate(sorted(seen)):
        e, m, k, n, shared = key
        gen = torch.Generator(device=dev).manual_seed(600 + i)
        b = max(e, 1)
        xb = 1 if shared else b
        xq = torch.randint(-127, 128, (xb, m, k), generator=gen, device=dev, dtype=torch.int8)
        sx = torch.rand((xb, m, 1), generator=gen, device=dev) + 0.5
        wq = torch.randint(-127, 128, (b, k, n), generator=gen, device=dev, dtype=torch.int8)
        sw = torch.rand((b, n), generator=gen, device=dev) + 0.5
        operands = ((xq.expand(b, m, k), wq, sx.expand(b, m, 1), sw) if e
                    else (xq[0], wq[0], sx[0], sw[0]))
        want = int8_matmul_plain(*operands)
        for call in ("first call", "second call"):
            got = int8_matmul(*operands)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                fail(f"int8_matmul at the path's shape {key} ({sorted(seen[key])}), {call}: not "
                     f"bit-identical to its plain version, max err "
                     f"{float((got - want).abs().max()):.3e}")
        checked.append(list(key))
        del xq, sx, wq, sw, operands, want, got
    torch.cuda.empty_cache()
    return {"legend": "[E (0: one 2-D product), M, K, N, x shared by the batch]",
            "shapes": checked, "paths": sorted(set().union(*seen.values())),
            "calls_each": 2, "max_abs_err": 0.0, "tolerance": 0.0}


def check_quantize_on_card(dev) -> dict:
    """quantize_params' quantizer on the card gives the CPU's bytes for one
    full-width weight (granite-3-8b's wg, 4096 x 12800, bf16)."""
    gen = torch.Generator().manual_seed(7)
    w = (torch.randn((4096, 12800), generator=gen) / 64.0).to(torch.bfloat16)
    cpu = quantize_weight(w, lead=0, n_contract=1)
    card = quantize_weight(w.to(dev), lead=0, n_contract=1)
    same = (torch.equal(card.q.cpu(), cpu.q)
            and torch.equal(card.scale.cpu().view(torch.int32), cpu.scale.view(torch.int32)))
    if not same:
        fail("quantize_weight on the card differs from the CPU's bytes")
    return {"shape": [4096, 12800], "dtype": "bfloat16", "bytes_identical": True}


def flash_flops(b, h, sq, sk, d, causal) -> float:
    """Two products of 2 flops per multiply-add over the (query, key) pairs
    this run needs: with a causal mask, query i sees min(i + 1, Sk) keys."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4.0 * b * h * pairs * d


FLASH_PARENT = FLASH_SHAPES[1]      # the granite shape in f32: the parent's K6 timed beside it


def check_flash(dev, parent: pathlib.Path | None = None):
    parent_flash = load_parent_flash(parent, dev)
    shapes = []
    for i, (b, h, kv, sq, sk, d, causal, dtype) in enumerate(FLASH_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        err = compare(got, want, "exact", tol, f"flash_attention {(b, h, kv, sq, sk, d)}")
        torch.cuda.synchronize()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
        lib_err = float((sdpa().float() - want.float()).abs().max())
        # the whole-row oracle keeps p in f32: in bf16 this is the error of
        # the kernel's bf16 p (a deliberate difference), held to the
        # reference's own bf16 tolerance against its oracle
        ref_err = compare(got, flash_attention_ref(q, k, v, causal=causal), "exact", tol,
                          f"flash_attention {(b, h, kv, sq, sk, d)} vs oracle")
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        flops = flash_flops(b, h, sq, sk, d, causal)
        bound_ms, bound_by = bound(nbytes(q, k, v) + nbytes(q), flops, peak)
        dev_ms = device_ms(lambda: flash_attention(q, k, v, causal=causal), reps=5)
        row = {
            "shape": [b, h, kv, sq, sk, d], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tolerance": tol,
            "ms": r6(time_ms(lambda: flash_attention(q, k, v, causal=causal), reps=10)),
            "device_ms": r6(dev_ms),
            "plain_ms": r6(time_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                                   reps=3, rounds=3)),
            "library_ms": r6(time_ms(sdpa, reps=10)),
            "library_device_ms": r6(device_ms(sdpa, reps=5)), "library_max_abs_diff": r6(lib_err),
            "oracle_max_abs_diff": r6(ref_err), "bound_ms": r6(bound_ms), "bound_by": bound_by,
        }
        if dtype == torch.float32:
            # the f32 kernel's three TF32 products a multiply-add, at the TF32 rate
            tf32_ms, tf32_by = bound(nbytes(q, k, v) + nbytes(q), 3 * flops, PEAK_TF32_FLOPS)
            row.update(bound_tf32x3_ms=r6(tf32_ms), bound_tf32x3_by=tf32_by)
        if parent_flash is not None and (b, h, kv, sq, sk, d, causal, dtype) == FLASH_PARENT:
            parent_err = compare(parent_flash(q, k, v, causal), want, "exact", tol,
                                 f"parent flash_attention {(b, h, kv, sq, sk, d)}")
            parent_ms = device_ms(lambda: parent_flash(q, k, v, causal), reps=5, uncounted=1)
            row.update(parent_device_ms=r6(parent_ms), parent_max_abs_err=r6(parent_err),
                       device_ms_over_parent=r6(None if parent_ms is None or dev_ms is None
                                                else dev_ms / parent_ms))
        shapes.append(row)
    return entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:95", shapes)


def drive_flash_path(dev) -> dict:
    """K6's own path: its public op at the granite-shaped causal case."""
    b, h, kv, sq, sk, d, causal, dtype = FLASH_MAIN
    gen = torch.Generator(device=dev).manual_seed(300)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if out.shape != q.shape or not bool(torch.isfinite(out.float()).all()):
        fail("ops.flash_attention: wrong shape or non-finite output")
    return {"expect": {"flash_attention": 1}}


# ---------------------------------------------------------------------------
# K7 decode_attention: GQA flash-decoding over the live rows of a KV cache
# ---------------------------------------------------------------------------
# (B, Smax, KV, D, g) of the served cells' decode attention: granite-3-8b
# chat (32 slots of 1536; the entry's own numbers), granite-moe-3b-a800m
# batch, granite-3-8b long documents (8 slots of 16384).
DECODE_SHAPES = [(32, 1536, 8, 128, 4), (32, 1536, 8, 64, 3), (8, 16384, 8, 128, 4)]
# (slots decoding, their position) at each shape in its cell's clear window
# (PERF.md §5): the live rows the timings and bounds are taken at; the other
# slots step at position 0 and read one row.
DECODE_CELL_ROWS = [(22, 488), (32, 404), (8, 10685)]
# Every other instantiation the serving paths reach, untimed: internvl2's
# group of 8, zamba2's D = 112 (one query head a KV head), the reduced
# configs' D = 16, and a group of 12 (starcoder2) taken in two blocks of 6.
DECODE_OTHER_SHAPES = [(4, 600, 8, 128, 8), (3, 700, 32, 112, 1), (2, 48, 2, 16, 2),
                       (2, 1100, 4, 16, 12)]
# Kernel against plain version.  Both sum in f32 from the same values, in
# another order (the splits' softmax and their merge against one softmax over
# the masked capacity), and the bf16 outputs are each one rounding of such an
# f32 sum: at most one bf16 unit apart, which is at most 2^-7 of the value,
# or a few f32 units where the output is f32.  So bf16 is held to 2^-7 of
# the value plus a floor of 2^-12 for outputs near 0, where the f32 sums'
# own differences (some 1e-7) are all that can show.  Read on an H100 80GB
# HBM3 at 700 W: max errors 0 to 9.8e-4 in bf16, 7e-8 to 4.8e-7 in f32; the
# largest share of its limit an error takes (``tolerance_used``, in each row
# of the report) 0.72 in bf16 (the graph replay and chat's shape at its
# cell's rows), 0.018 in f32.
DECODE_TOL_F32, DECODE_TOL_BF16, DECODE_FLOOR_BF16 = 2e-5, 2.0 ** -7, 2.0 ** -12


def decode_compare(got, want, what: str) -> dict:
    """``compare`` at the kernel's tolerance for ``got``'s type: the max
    error, the tolerance, and the largest share of its limit an error takes."""
    bf16 = got.dtype == torch.bfloat16
    tol = DECODE_TOL_BF16 if bf16 else DECODE_TOL_F32
    floor = DECODE_FLOOR_BF16 if bf16 else tol
    err = compare(got, want, "exact", tol, what, floor=floor)
    used = ((got.float() - want.float()).abs() / (floor + tol * want.float().abs())).max()
    return {"max_abs_err": r6(err), "tolerance": tol, "floor": floor,
            "tolerance_used": r6(float(used))}


def decode_operands(shape, dtype, dev, seed):
    """q, caches and positions of ``shape`` from ``seed``; positions uniform
    over the capacity, the first row's 0 and the last row's Smax - 1."""
    b, s, kv, d, g = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, kv * g, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    pos = torch.randint(0, s, (b,), generator=gen, device=dev)
    pos[0], pos[-1] = 0, s - 1
    return q, k, v, pos


def decode_live_bytes(q, k, pos) -> int:
    """What the call needs to move: each live K and V row of every KV head
    once (rows 0..pos[b] of row b), q read and the output written once."""
    _, s, kv, d = k.shape
    rows = int((pos.clamp(0, s - 1) + 1).sum())
    return 2 * rows * kv * d * k.element_size() + 2 * nbytes(q)


def decode_graph_replay(dev) -> dict:
    """The kernel captured once in a CUDA graph at the first shape, replayed
    with new positions written into its static ``pos``: each replay's output
    follows the new positions."""
    shape = DECODE_SHAPES[0]
    b, s = shape[:2]
    q, k, v, pos = decode_operands(shape, torch.bfloat16, dev, 450)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):  # makes the capture stream's counters
        decode_attention(q, k, v, pos)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = decode_attention(q, k, v, pos)
    rng = np.random.default_rng(451)
    seen = []
    for trial in range(4):
        new = torch.as_tensor(rng.integers(0, s, b), device=dev)
        new[trial] = s - 1
        pos.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        seen.append(decode_compare(out, decode_attention_plain(q, k, v, pos),
                                   f"decode_attention replay {trial}"))
    return {"shape": list(shape), "replays": 4,
            **{key: max(r[key] for r in seen) for key in ("max_abs_err", "tolerance_used")}}


def check_decode_attention(dev) -> dict:
    """K7 against its plain version at the cells' shapes, bf16 and f32; NaN
    written into every row past the positions gives the same bits (no such
    row is read; the plain version's 0 · NaN would be NaN, the one intended
    difference); the graph replay.  Timed in bf16 at each cell's live rows
    beside the bound (those rows' bytes at 3.35 TB/s), the plain version and
    the library (``scaled_dot_product_attention`` over the capacity with the
    positions as a mask; a yardstick, never called by the port)."""
    shapes = []
    for i, (shape, (decoding, at)) in enumerate(zip(DECODE_SHAPES, DECODE_CELL_ROWS)):
        b, s, kv, d, g = shape
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, pos = decode_operands(shape, dtype, dev, 400 + i)
            what = f"decode_attention {shape} {str(dtype).replace('torch.', '')}"
            got = decode_attention(q, k, v, pos)
            held = decode_compare(got, decode_attention_plain(q, k, v, pos), what)
            dead = torch.arange(s, device=dev)[None, :] > pos[:, None]
            kn, vn = k.clone(), v.clone()
            kn[dead], vn[dead] = float("nan"), float("nan")
            if not torch.equal(decode_attention(q, kn, vn, pos), got):
                fail(f"{what}: NaN past the positions changed the output")
            del kn, vn, dead
            row = {"shape": [b, s, kv, d, g], "dtype": str(dtype).replace("torch.", ""),
                   **held, "nan_past_pos_same_bits": True}
            if dtype == torch.bfloat16:
                pos = torch.zeros(b, dtype=torch.int64, device=dev)
                pos[:decoding] = at
                call = lambda: decode_attention(q, k, v, pos)  # noqa: E731
                mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
                want = decode_attention_plain(q, k, v, pos)
                cell = decode_compare(call(), want, f"{what} at the cell's rows")
                bound_ms, bound_by = bound(decode_live_bytes(q, k, pos),
                                           4.0 * kv * g * d * int((pos + 1).sum()))
                dev_ms = device_ms(call, reps=10)
                row.update(
                    cell_positions={"decoding": decoding, "at": at},
                    cell_max_abs_err=cell["max_abs_err"],
                    cell_tolerance_used=cell["tolerance_used"], ms=r6(time_ms(call, reps=20)),
                    device_ms=r6(dev_ms), bound_ms=r6(bound_ms), bound_by=bound_by,
                    bound_share=r6(None if dev_ms is None else bound_ms / dev_ms),
                    plain_ms=r6(time_ms(lambda: decode_attention_plain(q, k, v, pos), reps=3,
                                        rounds=3)),
                    library_ms=r6(time_ms(sdpa, reps=10)),
                    library_device_ms=r6(device_ms(sdpa, reps=5)),
                    library_max_abs_diff=r6(float((sdpa().transpose(1, 2).float()
                                                   - want.float()).abs().max())))
            shapes.append(row)
            del q, k, v
    for i, shape in enumerate(DECODE_OTHER_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, pos = decode_operands(shape, dtype, dev, 420 + i)
            held = decode_compare(decode_attention(q, k, v, pos),
                                  decode_attention_plain(q, k, v, pos),
                                  f"decode_attention {shape} {dtype}")
            shapes.append({"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                           **held})
    out = entry("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                "none (plain jnp in the JAX package: models/layers.py:attention_decode)", shapes)
    out["graph_replay"] = decode_graph_replay(dev)
    return out


@contextlib.contextmanager
def plain_decode_calls():
    """Counts the decode attention calls that took the plain version (CPU
    tensors) inside the block: every other call over the positions on one
    device launches the kernel.  Yields a one-element list."""
    real, seen = decode_mod.decode_attention_plain, [0]

    def counted(*a):
        seen[0] += 1
        return real(*a)

    decode_mod.decode_attention_plain = counted
    try:
        yield seen
    finally:
        decode_mod.decode_attention_plain = real


# ---------------------------------------------------------------------------
# serve_dense: int8-weight serving of granite-3-8b at full width
# ---------------------------------------------------------------------------
GEN_PROMPTS, GEN_LEN, GEN_NEW = 4, 64, 8
SLOT_PROMPTS = (16, 33, 40, 64)     # the last one is admitted after two ticks
SLOT_BUDGET, SLOT_TICKS = 12, 10
AGREEMENT_FLOOR = 0.3               # docs/kernels.md: the wiring floor of int8 serving
# One decoder block on the card against the CPU, bf16, same weights.  The two
# sum bf16 products in other orders, so their roundings to bf16 (2^-8
# relative) differ here and there; the attention scores, rounded to bf16
# before the softmax, carry such a difference into every output of the row,
# and a last-bit difference can move an activation across a rounding edge of
# its int8 row quantization (one step of amax / 127).  Measured on an H100:
# max error 2.2% and mean 0.22% of the block's largest output.  Rule: max
# within 5e-2 and mean within 5e-3 of the largest output; a wrong weight
# layout, scale or mask is off by tens of percent.
BLOCK_TOL, BLOCK_MEAN_TOL = 5e-2, 5e-3


def standard_fan_in(params, cfg) -> None:
    """Rescale a freshly drawn model in place where its random weights make
    it chaotic, so that agreement with its bf16 twin measures the int8 path
    and not the chaos: :func:`attention_fan_in`, and on the ssm and hybrid
    families :func:`depth_scaled_mamba` and
    :func:`embedding_at_residual_scale` (``ssm_rescale_check.py`` measures
    each step on the card)."""
    attention_fan_in(params, cfg)
    depth_scaled_mamba(params)
    embedding_at_residual_scale(params)


def attention_fan_in(params, cfg) -> None:
    """The 3-D attention weights to std 1/sqrt(width of their contraction).
    The reference's fan-in rule (kept by ``init_model``) takes ``shape[-2]``
    of a 3-D weight: the head count as the fan-in of wq (32) and wk/wv (8),
    and the head width (128) as that of wo; at full width that makes every
    attention row nearly one-hot, so a random model is chaotic: one int8
    rounding flips the attended key and two greedy chains part at their
    first token (agreement 0.000 measured on an H100).  The same rule takes
    the head count (128) for MLA's wq_b, wk_b and wv_b, whose contraction is
    a rank r (1536, 512), and the value width for its wo (h x v).  Expert
    weights (E, d, f) are right already: ``shape[-2]`` is their contraction.
    zamba2's shared block is a GQA attention too (``params["shared"]["attn"]``,
    one weight set, not stacked); the Mamba2 layers' weights are 2-D, where
    the rule reads their contraction.  whisper has three GQA attentions, all
    rescaled: its encoder's and its decoder's self- and cross-attention.
    With the reference's draw its cross-attention is one-hot over the
    stub's 1500 frames, and on the card a last-bit difference between
    blocking and chunked prefill moved a query to another frame: the
    random-frames prefill's logits 30% apart (``agreement_check.py`` on an
    H100 80GB HBM3 at 700 W)."""
    d, h = cfg.d_model, cfg.num_heads
    if cfg.mla is None:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        rules = (("wq", h, d), ("wk", kv, d), ("wv", kv, d), ("wo", hd, h * hd))
    else:
        m = cfg.mla
        rules = (("wq_b", h, m.q_lora_rank), ("wk_b", h, m.kv_lora_rank),
                 ("wv_b", h, m.kv_lora_rank), ("wo", m.v_head_dim, h * m.v_head_dim))
    attns = ([params["shared"]["attn"]] if "shared" in params else
             [params[s][a] for s in ("dense_blocks", "enc_blocks", "blocks") if s in params
              for a in ("attn", "self_attn", "cross_attn") if a in params[s]])
    if "mtp" in params:  # deepseek's MTP head: an MLA block, which training runs
        attns.append(params["mtp"]["block"]["attn"])
    for a in attns:
        for name, now, want in rules:
            a[name].mul_((now / want) ** 0.5)


def depth_scaled_mamba(params) -> None:
    """Each Mamba2 layer's projections (wz, wx, wB, wC, wdt, wo) times
    1/sqrt(l + 1), l its index in the stack (depth-scaled initialisation,
    Zhang, Titov & Sennrich 2019).  A random Mamba2 stack is chaotic: each
    block's gated product y * silu(z) doubles a relative perturbation of its
    input, and every later block re-amplifies what the earlier ones added,
    so the int8 path's rounding, a few percent a layer (the gate's output,
    int8-quantized by row before wo, has a largest entry ~12x its RMS),
    grows with depth.  Scaled, the first layers keep their size and later
    ones add less.  ``ssm_rescale_check.py`` on an H100 (80GB HBM3, 700 W):
    int8 against bf16, mamba2-780m's final hidden states 26% apart before
    and 5.6% after, zamba2-7b's 20% and 11.3%."""
    if "mamba" not in params.get("blocks", {}):
        return
    m = params["blocks"]["mamba"]
    depth = torch.arange(1, m["wo"].shape[0] + 1, dtype=torch.float32, device=m["wo"].device)
    for name in ("wz", "wx", "wB", "wC", "wdt", "wo"):
        m[name].mul_(depth.rsqrt().to(m[name].dtype)[:, None, None])


def embedding_at_residual_scale(params) -> None:
    """zamba2's (untied) and whisper's (tied) token embedding drawn at std 1
    in place of 0.02.  zamba2's shared block takes concat(x, x0), x0 the
    embedding, while the residual x it joins is of order 1: one int8 step of
    that row is larger than x0's entries, so the int8 engine's shared block
    loses the token identity it re-injects 14 times where the bf16 twin
    keeps it.  With it (``ssm_rescale_check.py``, same card): zamba2-7b's
    hidden states 4.6% apart, 87-92% of argmaxes kept.  whisper's decoder
    adds the embedding to a sinusoid of RMS 0.71: at 0.02 the tokens are a
    3% perturbation of the positions and every prompt's greedy chain is the
    same one token.  At std 1 the tokens reach the logits, but through the
    tied table: the residual holds the last token's row, so each chain
    repeats its prompt's last token (``serve_audio``'s ``distinct_tokens``
    says how many a run saw)."""
    if "shared" in params or "enc_blocks" in params:
        params["embed"]["tokens"].mul_(1 / 0.02)


def check_init_on_card(dev) -> dict:
    """The engine's own init on the card: weights drawn layer by layer from a
    CUDA generator and quantized as they are drawn.  Its peak memory must
    stay under what a full f32 copy of the projection stack alone would
    take."""
    cfg_q, _ = serve_configs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = engine_mod.InferenceEngine(cfg_q, sc=engine_mod.ServeConfig(max_batch=4, max_len=128),
                                     seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    proj = sum(t.q.numel() for t in _quant_leaves(eng.params))
    f32_stack = 4 * proj
    if peak >= f32_stack:
        fail(f"init_on_card: peak {peak} bytes, not under an f32 copy of the stack ({f32_stack})")
    del eng
    torch.cuda.empty_cache()
    return {"seconds": r6(seconds), "peak_bytes": peak, "int8_projection_bytes": proj,
            "f32_projection_stack_bytes": f32_stack}


def k5_per_call(cfg, kind: str) -> int:
    """int8_matmul launches of one model call (``prefill``, ``decode_step``,
    ``prefill_chunk`` or ``decode_verify``), from the code: 7 a layer for
    granite-3-8b and granite-moe (wq, wk, wv, wo, then wg, wu, wd, each of
    granite-moe's three expert einsums ONE launch over all 48 experts; the
    router is a plain f32 product).  deepseek's MLA makes 6 at prefill
    (wq_a, wq_b, wkv_a, wk_b and wv_b decompressing K/V, wo) and 4 at decode
    and chunk (the absorbed wk_b and wv_b contract over non-leading axes and
    go through dequantize, as in the reference); its dense MLP 3; its MoE 3
    expert launches + 3 of the shared expert.  A Mamba2 layer makes 3 (wz, wx,
    wo; wB, wC and wdt are plain products) and an application of zamba2's
    shared block 9 (w_in, wq, wk, wv, wo, wg, wu, wd, w_out): 144 a call for
    mamba2-780m, 243 + 14 x 9 = 369 for zamba2-7b.  whisper's encoder makes 6
    a layer (wq, wk, wv, wo, wi, wo), its decoder 10 a layer at prefill (self
    wq, wk, wv, wo; cross wq, wk and wv over the encoder output, wo; wi, wo)
    and 8 at decode, chunk and verify, whose cross K/V are the cache's;
    ``encoder_cross_cache`` the encoder's and 2 a decoder layer (cross wk,
    wv): 64 / 32 / 32 for whisper-tiny."""
    if cfg.family == "audio":
        enc, dec = 6 * cfg.encoder_layers, cfg.num_layers
        return {"prefill": enc + 10 * dec, "encoder_cross_cache": enc + 2 * dec}.get(
            kind, 8 * dec)
    if cfg.family in ("ssm", "hybrid"):
        apps = math.ceil(cfg.num_layers / cfg.attn_every) if cfg.family == "hybrid" else 0
        return 3 * cfg.num_layers + 9 * apps
    if cfg.mla is None:
        return 7 * cfg.num_layers
    attn = 6 if kind == "prefill" else 4
    k = cfg.first_k_dense
    return k * (attn + 3) + (cfg.num_layers - k) * (attn + 6)


class CallLog:
    """Wraps model functions the engine calls (``prefill``, ``decode_step``,
    ``prefill_chunk``, ``decode_verify``, and whisper's
    ``encoder_cross_cache``): each call is synchronised and timed, its
    int8_matmul launches counted against ``k5_per_call`` of its config, its
    logits (the cross K/V of ``encoder_cross_cache``) kept and checked
    finite.  A call made while a CUDA
    graph is being captured runs nothing and passes through unlogged."""

    def __init__(self):
        self.calls: list[dict] = []

    def wrap(self, kind, fn):
        def call(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kw)
            torch.cuda.synchronize()
            before = runtime.launch_counts().get("int8_matmul", 0)
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kw)
            torch.cuda.synchronize()
            cfg = next(a for a in (*args, *kw.values()) if isinstance(a, ArchConfig))
            self.calls.append({
                "kind": kind, "ms": (time.perf_counter() - t0) * 1e3,
                "int8_matmul": runtime.launch_counts().get("int8_matmul", 0) - before,
                "per_call": k5_per_call(cfg, kind) if cfg.quant == "int8" else 0,
                "finite": bool(torch.isfinite(logits).all()),
                "rows": int(logits.shape[0]), "logits": logits})
            return logits, cache
        return call

    def check(self, what: str) -> None:
        for c in self.calls:
            if c["int8_matmul"] != c["per_call"]:
                fail(f"{what}: a {c['kind']} call launched int8_matmul {c['int8_matmul']} "
                     f"times, {c['per_call']} expected (k5_per_call)")
            if not c["finite"]:
                fail(f"{what}: non-finite logits in a {c['kind']} call")

    def __enter__(self):
        self.real = {name: getattr(engine_mod, name) for name in
                     ("prefill", "decode_step", "prefill_chunk", "decode_verify",
                      "encoder_cross_cache")}
        for name, fn in self.real.items():
            setattr(engine_mod, name, self.wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(engine_mod, name, fn)


def serve_configs():
    cfg = dataclasses.replace(get_config(GRANITE), num_layers=SERVE_LAYERS)
    return dataclasses.replace(cfg, quant="int8"), cfg


def image_rows(eng) -> int:
    """Positions a prompt of the vision-language model gives its image: the
    ``frontend_seq`` patch rows of the engine's front-end stub take the
    place of its first tokens, so every prompt of the serving helpers is
    that much longer (256 image positions, then the text); 0 otherwise."""
    return eng.cfg.frontend_seq if eng.cfg.frontend == "vision" else 0


def slot_path(eng, rng):
    """A slot pool of 4: prompts of ``SLOT_PROMPTS`` tokens (after the image
    rows, :func:`image_rows`) admitted at tick 0 (the last at tick 2),
    ``SLOT_TICKS`` masked decode ticks (the first captures the graph, the
    others replay it), each slot retired at its budget.  Returns (pool,
    tokens by slot, tick ms, every live slot finite)."""
    vocab, lead = eng.cfg.vocab_size, image_rows(eng)
    pool = eng.make_pool()
    slot_tokens = {s: [] for s in range(len(SLOT_PROMPTS))}
    slot_finite, tick_ms = True, []
    for tick in range(SLOT_TICKS):
        if tick == 0:
            for s, n in enumerate(SLOT_PROMPTS[:-1]):
                p = rng.integers(0, vocab, lead + n).astype(np.int32)
                slot_tokens[s].append(eng.prefill_into_slot(pool, s, p, rid=s,
                                                            budget=SLOT_BUDGET))
        if tick == 2:
            s = len(SLOT_PROMPTS) - 1
            p = rng.integers(0, vocab, lead + SLOT_PROMPTS[s]).astype(np.int32)
            slot_tokens[s].append(eng.prefill_into_slot(pool, s, p, rid=s, budget=SLOT_BUDGET))
        live = pool.decode_mask().copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, fin = eng.masked_decode_step(pool)  # the first tick captures the graph
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        slot_finite = slot_finite and bool(fin[live].all())
        for s in map(int, np.flatnonzero(live)):
            pool.advance(s, 1, int(nxt[s]))
            slot_tokens[s].append(int(nxt[s]))
            if pool.slots[s].emitted >= pool.slots[s].budget:
                pool.retire(s)
    return pool, slot_tokens, tick_ms, slot_finite


def drive_serve_dense(dev) -> dict:
    """generate and the slot path through the int8 engine; the full-precision
    engine on the same weights for greedy-chain agreement."""
    cfg_q, cfg_f = serve_configs()
    sc = engine_mod.ServeConfig(max_batch=4, max_len=128)
    params = init_model(cfg_f, torch.Generator(device=dev).manual_seed(0), dev)
    standard_fan_in(params, cfg_f)
    t0 = time.perf_counter()
    eng = engine_mod.InferenceEngine(cfg_q, params=params, sc=sc)  # quantizes at init
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.q.numel() for t in _quant_leaves(eng.params))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg_q.vocab_size, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)

    with CallLog() as log:
        t0 = time.perf_counter()
        tokens_q = eng.generate(prompts, GEN_NEW)
        generate_s = time.perf_counter() - t0
        n_generate = len(log.calls)
        pool, slot_tokens, tick_ms, slot_finite = slot_path(eng, rng)
    log.check("serve_dense")
    per_call = 7 * cfg_q.num_layers
    graph = eng.step_graphs(pool)[("decode", 0)]
    if graph.launches.get("int8_matmul") != per_call or graph.replays != SLOT_TICKS:
        fail(f"serve_dense: the decode graph holds {graph.launches} launches and was "
             f"replayed {graph.replays} times ({per_call} int8_matmul, {SLOT_TICKS} expected)")
    if not slot_finite:
        fail("serve_dense: masked_decode_step flagged a live slot non-finite")
    if tokens_q.shape != (GEN_PROMPTS, GEN_NEW):
        fail(f"serve_dense: generate returned {tokens_q.shape}")

    # the same engine without quantization, on the same weights
    full = engine_mod.InferenceEngine(cfg_f, params=params, sc=sc)
    tokens_f = full.generate(prompts, GEN_NEW)
    agreement = float((tokens_q == tokens_f).mean())
    if agreement < AGREEMENT_FLOOR:
        fail(f"serve_dense: greedy-chain agreement {agreement:.3f} with the full-precision "
             f"engine, under the floor {AGREEMENT_FLOOR}")
    del full
    gen_calls = log.calls[:n_generate]
    decode_ms = [c["ms"] for c in gen_calls if c["kind"] == "decode_step"]
    slot_prefill_ms = [c["ms"] for c in log.calls[n_generate:] if c["kind"] == "prefill"]
    report = {
        "arch": GRANITE, "layers": cfg_q.num_layers, "of_layers": get_config(GRANITE).num_layers,
        "dtype": "bfloat16", "quant": "int8", "int8_weight_bytes": weight_bytes,
        "quantize_at_init_s": r6(init_s), "generate": {
            "prompts": GEN_PROMPTS, "prompt_len": GEN_LEN, "new_tokens": GEN_NEW,
            "seconds": r6(generate_s), "prefill_ms": r6(gen_calls[0]["ms"]),
            "decode_ms_median": r6(statistics.median(decode_ms)),
            "decode_ms": [r6(t) for t in decode_ms]},
        "slots": {"max_batch": 4, "max_len": 128, "prompts": list(SLOT_PROMPTS),
                  "prefill_ms": [r6(t) for t in slot_prefill_ms],
                  "tick_ms_median": r6(statistics.median(tick_ms[1:])),
                  "tick_ms": [r6(t) for t in tick_ms], "tokens": slot_tokens},
        "calls": len(log.calls), "graph_replays": graph.replays,
        "int8_matmul_per_call": per_call,
        "greedy_agreement_vs_full_precision": r6(agreement),
        "agreement_floor": AGREEMENT_FLOOR,
    }
    # the first tick's warm-up is a logged call; replays run the captured launches
    return {"expect": {"int8_matmul": per_call * (len(log.calls) + graph.replays)},
            "report": report, "engine": eng}


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA, a trace
    holding every launched kernel, ``profiled``): wall time, device-busy time
    (the kernels' own device time; the operators that launched them are not
    counted again), the idle share, and the device time of int8_matmul and of
    the largest other kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    sample = profiled(fn, activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if sample is None:
        fail("profile: no trace held every kernel the call launched")
    prof, wall_ms = sample
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                       key=lambda t: -t[1])
    busy = sum(t for _, t, _ in by_kernel)
    k5 = [(t, c) for k, t, c in by_kernel if "int8_matmul_kernel" in k]
    # first kernel start to last kernel end: span - busy is the device's idle
    # time between the call's kernels, wall - span the host's share around them
    kernels = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA]
    span = (max(r.end for r in kernels) - min(r.start for r in kernels)) / 1e3
    return {"wall_ms": r6(wall_ms), "device_busy_ms": r6(busy), "device_span_ms": r6(span),
            "idle_share": r6(1.0 - busy / wall_ms) if wall_ms else None,
            "int8_matmul_device_ms": r6(sum(t for t, _ in k5)),
            "int8_matmul_events": sum(c for _, c in k5),
            "port_kernel_events": port_kernel_events(prof),
            "device_launches": sum(c for _, _, c in by_kernel),
            "top_kernels_ms": [[k[:60], r6(t), c] for k, t, c in by_kernel[:6]]}


def profile_serve(eng, dev) -> dict:
    """Where a call's time goes: one prefill of the generate workload
    (``generate(prompts, 1)``: prefill + one decode) and one decode tick of
    4 live slots (a replayed graph), each under ``torch.profiler``."""
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, eng.cfg.vocab_size, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    pool = eng.make_pool()
    for s, n in enumerate(SLOT_PROMPTS):
        p = rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
        eng.prefill_into_slot(pool, s, p, rid=s, budget=SLOT_BUDGET)
    return {"generate_1": profile_call(lambda: eng.generate(prompts, 1)),
            "decode_tick_4_slots": profile_call(lambda: eng.masked_decode_step(pool))}


# ---------------------------------------------------------------------------
# serve_engine: the rest of the contiguous engine at full width, the decode
# and verify ticks replayed as CUDA graphs
# ---------------------------------------------------------------------------
ENGINE_SC = {"max_batch": 4, "max_len": 128, "spec_slack": 4}
GROUP_LEN, CHUNK_TOKENS = 64, 16    # a group of 2 prompts of 64 tokens, in chunks of 16
DECODING_PROMPTS = (24, 40)         # slots 2 and 3 decode while the group prefills
SPEC_K = 4
SPEC_PROMPTS = (16, 33, 40, 25)
CHAIN_TICKS = 16                    # the plain chain the verify windows are taken from
FORCED_TICKS = 3                    # teacher-forced verify ticks: 3 x 4 slots x 5 positions
VERIFY_AGREEMENT = 0.95             # per-position argmax agreement, verify vs plain decode
# A verify position whose token differs from plain decode's must be a near
# tie of the plain chain's own logits: its margin between the two tokens at
# most VERIFY_TIE of the largest |logit|.  And no position's logits may differ
# from plain decode's by more than VERIFY_LOGIT_DIFF of the largest |logit|:
# a window scored at the wrong positions or over the wrong rows moves them by
# their own size.  (Read on an H100 80GB HBM3 at 700 W: flips at margins
# 0-0.015; largest differences 0.017 granite-3-8b, 0.032 granite-moe, 0.082
# deepseek-v3.)
VERIFY_TIE = 0.05
VERIFY_LOGIT_DIFF = 0.25
TIMED_TICKS = 15                    # unprofiled ticks a kind, replayed and eager in turns
ENGINE_BUDGET = 40


def decode_chain(eng, pool, chains: dict, ticks: int, what: str, logits: list | None = None
                 ) -> None:
    """``ticks`` masked-decode ticks; every decoding slot's token is committed
    and appended to its chain, and each tick's logits (B, V) to ``logits``
    when it is given."""
    for _ in range(ticks):
        live = pool.decode_mask().copy()
        nxt, fin = eng.masked_decode_step(pool)
        if not fin[live].all():
            fail(f"{what}: a decoding slot read non-finite")
        if logits is not None:
            out = eng.step_graphs(pool)[("decode", 0)].outputs["logits"]
            logits.append(out[:, :eng.cfg.vocab_size].float().cpu())
        for s in map(int, np.flatnonzero(live)):
            pool.advance(s, 1, int(nxt[s]))
            chains[s].append(int(nxt[s]))


def host_accepted(drafts, tokens) -> np.ndarray:
    """Greedy prefix acceptance recomputed on the host."""
    return np.cumprod(drafts == tokens[:, :-1], axis=1).sum(axis=1)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def graph_vs_eager(g, what: str, **inputs) -> dict:
    """One replay of graph ``g`` and the same step run eagerly on a copy of
    its cache, from the same inputs: every output and the caches after must
    be the same bits, and the zeroed workspaces of the capture stream (K5's
    split-K sums and counters, K7's tickets) must be back at zero."""
    g.load(**inputs)
    copy = {k: v.clone() for k, v in g.cache.items()}
    replayed = {k: v.clone() for k, v in g.replay().items()}
    eager = g.eager(copy)
    torch.cuda.synchronize()
    for name, out in replayed.items():
        if not same_bits(out, eager[name]):
            fail(f"{what}: the replayed tick's {name} differs from the eager tick's")
    for key, t in copy.items():
        if not same_bits(t, g.cache[key]):
            fail(f"{what}: the replayed tick's cache {key!r} differs from the eager tick's")
    held = {name: t for (name, d, s), t in runtime._zeroed.items()
            if (d, s) == (g.device.index, g.stream.cuda_stream)}
    if "int8_matmul.counters" not in held or any(bool(t.any()) for t in held.values()):
        fail(f"{what}: a zeroed workspace of the capture stream (K5's split-K sums and "
             f"counters, K7's tickets: {sorted(held)}) is not back at zero after a replay")
    return {"outputs_bitwise_equal": sorted(replayed), "cache_bitwise_equal": True,
            "workspace_zero": True, "launches_a_replay": g.launches}


def forced_verify(eng, vpool, chain: dict, chain_logits: list, what: str
                  ) -> tuple[dict, np.ndarray]:
    """``FORCED_TICKS`` verify ticks of the four slots of ``vpool`` (prefilled
    as the plain ``chain`` was), the drafts teacher-forced from the chain,
    then one tick of always-wrong drafts, which must accept none (its
    position 0 alone is compared: the later ones read the wrong drafts).
    The per-position argmax agreement with the chain must reach
    ``VERIFY_AGREEMENT`` (``MOE_VERIFY_FLOOR`` for the moe family and the
    vision-language model) over at
    least 32 positions.  Each position's logits are held against the
    chain's (``chain_logits``, one (B, V) a tick): their largest difference
    at most ``VERIFY_LOGIT_DIFF``, and where the tokens differ the chain's
    own margin between the two at most ``VERIFY_TIE``, of the largest
    |logit|.
    On the moe family the ticks with such flips are run again eagerly with
    the router recorded (:func:`flip_routes`).  Returns the report and the
    last tick's drafts."""
    vocab, routes = eng.cfg.vocab_size, eng.cfg.moe is not None
    floor = MOE_VERIFY_FLOOR if routes or eng.cfg.family == "vlm" else VERIFY_AGREEMENT
    agree = positions = 0
    worst, flips, route_reports = 0.0, [], []
    for tick in range(FORCED_TICKS + 1):
        es = [vpool.slots[s].emitted for s in range(4)]  # a slot that flipped is behind
        n = min(SPEC_K + 1, *(len(chain[s]) - e for s, e in enumerate(es)))
        want = np.asarray([chain[s][e:e + n] for s, e in enumerate(es)])
        drafts = want[:, :SPEC_K].astype(np.int32)
        if tick == FORCED_TICKS:  # always wrong: the first draft is not the plain token
            drafts = ((want[:, :1] + 1 + np.arange(SPEC_K)) % vocab).astype(np.int32)
        before = ({k: v.clone() for k, v in vpool.cache.items()}, vpool.tok.copy(),
                  vpool.positions().copy()) if routes else None
        toks, acc, fin = eng.masked_speculative_step(vpool, drafts)
        if not fin.all() or not (acc == host_accepted(drafts, toks)).all():
            fail(f"{what}: verify tick {tick}: finite {fin}, accepted {acc}")
        n = min(want.shape[1], toks.shape[1])
        if tick == FORCED_TICKS:  # past position 0 the window reads the wrong drafts
            n = 1
        agree += int((toks[:, :n] == want[:, :n]).sum())
        positions += want[:, :n].size
        lv = eng.step_graphs(vpool)[("verify", SPEC_K)].outputs["logits"][..., :vocab].float().cpu()
        tick_flips = []
        for s in range(4):
            for j in range(n):
                ld = chain_logits[es[s] + j - 1][s]  # decode tick e + j gave chain[s][e + j]
                scale = float(ld.abs().max())
                worst = max(worst, float((lv[s, j] - ld).abs().max()) / scale)
                a, b = int(want[s, j]), int(toks[s, j])
                if a != b:
                    tick_flips.append({"tick": tick, "slot": s, "j": j, "chain": a, "verify": b,
                                       "chain_margin_rel": r6(float(ld[a] - ld[b]) / scale)})
        if routes and tick_flips:
            route_reports.append(flip_routes(eng, *before, drafts, tick_flips))
        flips += tick_flips
        if tick < FORCED_TICKS:  # each slot commits its accepted drafts, then the chain's token
            for s in range(4):
                a = int(acc[s])
                vpool.advance(s, a + 1, chain[s][es[s] + a])
        elif acc.any():
            fail(f"{what}: always-wrong drafts accepted {acc}")
    agreement = agree / positions
    report = {"k": SPEC_K, "positions": positions, "per_position_agreement": r6(agreement),
              "floor": floor, "always_wrong_accepted": acc.tolist(),
              "logits_max_abs_diff_rel": r6(worst), "logits_diff_limit": VERIFY_LOGIT_DIFF,
              "flips": flips, "flip_margin_limit": VERIFY_TIE}
    if routes:
        report["flip_routes"] = route_reports
    if positions < 32 or agreement < floor:
        fail(f"{what}: verify agrees with plain decode at {agreement:.3f} of {positions} "
             f"positions (floor {floor} over >= 32): {json.dumps(report)}")
    if worst > VERIFY_LOGIT_DIFF or any(f["chain_margin_rel"] > VERIFY_TIE for f in flips):
        fail(f"{what}: verify's logits differ from plain decode's by {worst:.3f} (limit "
             f"{VERIFY_LOGIT_DIFF}), or a flip is no near tie (limit {VERIFY_TIE}): "
             f"{json.dumps(report)}")
    return report, drafts


def routed(fn):
    """``fn()`` with the MoE router recording each of its calls (one a MoE
    layer): every token's expert set and the gap between the probability of
    the last expert it takes and of the first it leaves."""
    calls, real = [], moe_mod._router

    def recording(params, x2d, cfg):
        w, ids, probs = real(params, x2d, cfg)
        edge = torch.sort(probs, dim=-1, descending=True).values[:, cfg.moe.top_k - 1:
                                                                  cfg.moe.top_k + 1]
        calls.append((ids.sort(dim=-1).values.cpu(), (edge[:, 0] - edge[:, 1]).cpu()))
        return w, ids, probs

    moe_mod._router = recording
    try:
        return fn(), calls
    finally:
        moe_mod._router = real


def flip_routes(eng, cache, tok, pos, drafts, flips) -> dict:
    """One verify tick whose tokens differ from plain decode, run again
    eagerly from a copy of its cache: the verify window, and the same K+1
    inputs decoded one at a time from another copy, the router recorded in
    both (launches recorded apart: a diagnosis, not the path).  For every
    token, the MoE layers whose expert set differs between the two, and the
    router's gap there; for each flip, the eager runs' tokens."""
    cfg, dev, k = eng.cfg, eng.device, drafts.shape[1]
    tokens = torch.as_tensor(np.concatenate([tok[:, None], drafts], 1).astype(np.int64),
                             device=dev)
    p = torch.as_tensor(pos.astype(np.int64), device=dev)
    with runtime.launches_recorded(), torch.inference_mode():
        copy = {n: t.clone() for n, t in cache.items()}
        (vlog, _), vcalls = routed(lambda: model_mod.decode_verify(eng.params, copy, tokens, p, cfg))
        copy = {n: t.clone() for n, t in cache.items()}
        steps = [routed(lambda j=j: model_mod.decode_step(eng.params, copy, tokens[:, j:j + 1],
                                                          p + j, cfg)) for j in range(k + 1)]
    vocab = cfg.vocab_size
    differ = []  # (slot, j, layer, verify's gap, decode's gap) where the expert sets differ
    for j, ((_, _), dcalls) in enumerate(steps):
        for layer, ((vid, vgap), (did, dgap)) in enumerate(zip(vcalls, dcalls)):
            for s in range(tok.shape[0]):
                r = s * (k + 1) + j
                if not torch.equal(vid[r], did[s]):
                    differ.append([s, j, layer, r6(float(vgap[r])), r6(float(dgap[s]))])
    out = {"tick": flips[0]["tick"], "moe_layers": len(vcalls), "tokens": tok.shape[0] * (k + 1),
           "expert_sets_differ": differ, "flips": []}
    for f in flips:
        s, j = f["slot"], f["j"]
        out["flips"].append({
            "slot": s, "j": j, "eager_verify": int(vlog[s, j, :vocab].argmax()),
            "eager_decode": int(steps[j][0][0][s, :vocab].argmax()),
            "layers_differ": [d[2] for d in differ if d[0] == s and d[1] == j]})
    return out


def strict_identity(dev, arch: str = GRANITE, quant: str | None = "int8") -> tuple[dict, list]:
    """The reduced config of ``arch`` of the CPU tests, in f32 (with int8
    weights unless ``quant`` is None), on the card: chunked prefill against
    blocking prefill, and speculative verify (oracle drafts in one slot,
    always-wrong in the other) against plain decode.  Tokens must be
    identical.  MLA with int8 weights skips the first: its blocking prefill
    decompresses K/V through int8 ``wk_b`` / ``wv_b`` (c row-quantized)
    where its chunk step contracts with the dequantized weights, as in the
    reference, so the two agree to quantization noise only (the reference
    claims that identity in f32 without int8, ``tests/test_serving.py``).
    Verify and decode both take the absorbed path: speculative == plain
    holds with int8 weights too."""
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32, quant=quant)
    chunked = quant is None or cfg.mla is None
    # f32 weights, as the CPU tests carry them (init_model draws bf16 leaves)
    params = tree_map(lambda t: t.float(), init_model(cfg, torch.Generator(dev).manual_seed(0),
                                                      dev))
    eng = engine_mod.InferenceEngine(
        cfg, params=params, sc=engine_mod.ServeConfig(max_batch=3, max_len=48, spec_slack=SPEC_K))
    prompts = np.random.default_rng(41).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    pools = [eng.make_pool() for _ in range(3)]
    block = {j: [eng.prefill_into_slot(pools[0], j, prompts[j], rid=j, budget=10)]
             for j in range(2)}
    decode_chain(eng, pools[0], block, 6, "strict identity")
    if chunked:
        st = eng.begin_chunked_prefill(pools[1], [0, 1], prompts, rids=[0, 1], budgets=[10, 10])
        while not st.done:
            eng.chunked_prefill_step(st, 4)
        chunk = {j: [int(t)] for j, t in enumerate(eng.finish_chunked_prefill(pools[1], st))}
        decode_chain(eng, pools[1], chunk, 6, "strict identity")
        if chunk != block:
            fail(f"strict identity: chunked prefill {chunk} != blocking {block}")
    ref, pool = block[0], pools[2]
    good = [eng.prefill_into_slot(pool, 0, prompts[0], rid=0, budget=len(ref))]
    bad = [eng.prefill_into_slot(pool, 1, prompts[0], rid=1, budget=len(ref))]
    ticks = 0
    while len(bad) < len(ref):
        drafts = np.zeros((3, SPEC_K), np.int32)
        drafts[0] = (ref[len(good):len(good) + SPEC_K] + [0] * SPEC_K)[:SPEC_K]
        drafts[1] = [(t + 1) % cfg.vocab_size for t in
                     (ref[len(bad):len(bad) + SPEC_K] + [0] * SPEC_K)[:SPEC_K]]
        out, acc, fin = eng.masked_speculative_step(pool, drafts)
        ticks += 1
        if not fin[:2].all() or acc[1] != 0:
            fail(f"strict identity: verify tick {ticks}: finite {fin}, accepted {acc}")
        if len(good) < len(ref):
            n = min(int(acc[0]) + 1, len(ref) - len(good))
            good.extend(out[0, :n].tolist())
            pool.advance(0, n, int(out[0, n - 1]))
        bad.append(int(out[1, 0]))
        pool.advance(1, 1, int(out[1, 0]))
    if good != ref or bad != ref:
        fail(f"strict identity: speculative {good} / {bad} != plain decode {ref}")
    graphs = [g for p in pools for g in eng.step_graphs(p).values()]
    return {"config": cfg.name, "dtype": "float32", "quant": quant,
            "layers": cfg.num_layers, "tokens": ref, "verify_ticks": ticks,
            "chunked_equals_blocking": True if chunked else "not run",
            "speculative_equals_plain": True}, graphs


def strict_identity_logged(dev, arch: str, what: str, quant: str | None = "int8"
                           ) -> tuple[dict, int]:
    """:func:`strict_identity` with its calls logged; returns (report, the
    int8_matmul launches it made)."""
    with CallLog() as log:
        report, graphs = strict_identity(dev, arch, quant)
    log.check(what)
    return report, (sum(c["per_call"] for c in log.calls)
                    + sum(g.replays * g.launches.get("int8_matmul", 0) for g in graphs))


def drive_serve_engine(dev, base) -> dict:
    """Chunked prefill, speculative verify and poison/resume through the int8
    engine of ``serve_dense`` (same weights, ``spec_slack`` = 4), the replayed
    ticks held bit for bit to the eager ones, and the reduced config's strict
    token identity."""
    cfg = base.cfg
    eng = engine_mod.InferenceEngine(cfg, params=base.params,
                                     sc=engine_mod.ServeConfig(**ENGINE_SC))
    vocab, per_call = cfg.vocab_size, 7 * cfg.num_layers
    rng = np.random.default_rng(40)
    report, k5_rows = {}, []
    real_k5 = quant_mod.int8_matmul

    def k5_logged(*a):
        k5_rows.append(int(a[0].shape[0]))
        return real_k5(*a)

    with CallLog() as log:
        # -- chunked prefill of a group while two slots decode --------------
        pool = eng.make_pool()
        chains = {2 + i: [eng.prefill_into_slot(pool, 2 + i, p, rid=2 + i, budget=ENGINE_BUDGET)]
                  for i, p in enumerate(rng.integers(0, vocab, n).astype(np.int32)
                                        for n in DECODING_PROMPTS)}
        group = rng.integers(0, vocab, (2, GROUP_LEN)).astype(np.int32)
        n0 = len(log.calls)
        st = eng.begin_chunked_prefill(pool, [0, 1], group, rids=[0, 1],
                                       budgets=[ENGINE_BUDGET] * 2)
        while not st.done:
            eng.chunked_prefill_step(st, CHUNK_TOKENS)
            decode_chain(eng, pool, chains, 1, "serve_engine chunked prefill")
        chunk_calls = [c for c in log.calls[n0:] if c["kind"] == "prefill_chunk"]
        first = eng.finish_chunked_prefill(pool, st)
        chains.update({j: [int(first[j])] for j in range(2)})
        decode_chain(eng, pool, chains, 2, "serve_engine after the group")
        n1 = len(log.calls)
        blocking_first = [eng.prefill_into_slot(eng.make_pool(), 0, group[j], rid=j,
                                                budget=ENGINE_BUDGET) for j in range(2)]
        block_logits = torch.cat([c["logits"] for c in log.calls[n1:]])[:, :vocab]
        chunk_logits = chunk_calls[-1]["logits"][:, :vocab]
        if len(chunk_calls) != GROUP_LEN // CHUNK_TOKENS or chunk_logits.shape != (2, vocab):
            fail(f"serve_engine: {len(chunk_calls)} chunk calls of {chunk_logits.shape}")
        report["chunked_prefill"] = {
            "group": [2, GROUP_LEN], "chunk_tokens": CHUNK_TOKENS, "chunk_calls": len(chunk_calls),
            "chunk_ms": [r6(c["ms"]) for c in chunk_calls], "first_tokens": first.tolist(),
            "first_tokens_blocking": blocking_first,
            "max_abs_logit_diff_vs_blocking": r6(float((chunk_logits - block_logits).abs().max())),
            "max_abs_logit": r6(float(block_logits.abs().max())),
            "decoding_slots_ticked_between_chunks": [2, 3]}

        # -- speculative verify, teacher-forced from the plain chain --------
        prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in SPEC_PROMPTS]
        plain = eng.make_pool()
        chain = {s: [eng.prefill_into_slot(plain, s, p, rid=s, budget=ENGINE_BUDGET)]
                 for s, p in enumerate(prompts)}
        chain_logits = []
        decode_chain(eng, plain, chain, CHAIN_TICKS, "serve_engine plain chain", chain_logits)
        vpool = eng.make_pool()
        for s, p in enumerate(prompts):
            if eng.prefill_into_slot(vpool, s, p, rid=s, budget=ENGINE_BUDGET) != chain[s][0]:
                fail("serve_engine: the same prefill gave another first token")
        quant_mod.int8_matmul = k5_logged  # the first verify tick: warm-up and capture
        try:
            report["speculative"], drafts = forced_verify(eng, vpool, chain, chain_logits,
                                                          "serve_engine")
        finally:
            quant_mod.int8_matmul = real_k5
        vgraph = eng.step_graphs(vpool)[("verify", SPEC_K)]
        if set(k5_rows) != {4 * (SPEC_K + 1)} or vgraph.launches.get("int8_matmul") != per_call:
            fail(f"serve_engine: verify graph holds {vgraph.launches} launches at rows "
                 f"{sorted(set(k5_rows))} ({per_call} at M = {4 * (SPEC_K + 1)} expected)")
        report["speculative"].update(prompts=list(SPEC_PROMPTS), int8_matmul_rows=4 * (SPEC_K + 1))

        # -- poison one slot, quarantine it, resume it ------------------------
        report["poison_resume"] = poison_resume(eng, plain, prompts, chain, "serve_engine")

        # -- the replayed ticks against the eager ones -----------------------
        dgraph = eng.step_graphs(plain)[("decode", 0)]
        report["graph_vs_eager"] = {
            "decode": graph_vs_eager(dgraph, "decode tick", tok=plain.tok,
                                     pos=plain.positions(), active=plain.decode_mask()),
            "verify": graph_vs_eager(vgraph, "verify tick", tok=vpool.tok, drafts=drafts,
                                     pos=vpool.positions(), active=vpool.decode_mask())}

        report["strict_identity"], strict_graphs = strict_identity(dev)
    log.check("serve_engine")
    graphs = [g for p in (pool, plain, vpool) for g in eng.step_graphs(p).values()]
    for g in graphs:
        if g.launches.get("int8_matmul") != per_call:
            fail(f"serve_engine: a graph holds {g.launches} launches, {per_call} int8_matmul "
                 "expected")
    replayed = sum(g.replays * g.launches.get("int8_matmul", 0) for g in graphs + strict_graphs)
    report.update(calls=len(log.calls), graphs=len(graphs) + len(strict_graphs),
                  replays=sum(g.replays for g in graphs + strict_graphs),
                  int8_matmul_per_call=per_call)
    return {"expect": {"int8_matmul": sum(c["per_call"] for c in log.calls) + replayed},
            "report": report, "engine": eng, "pools": (plain, vpool), "drafts": drafts}


def time_engine_ticks(driven) -> dict:
    """Unprofiled wall time of the replayed decode and verify ticks (the
    engine's own calls, host input and output included) and of the same
    steps run eagerly on a copy of the cache, in turns, then one of each
    under the profiler."""
    eng, (plain, vpool), drafts = driven["engine"], driven["pools"], driven["drafts"]
    dgraph = eng.step_graphs(plain)[("decode", 0)]
    vgraph = eng.step_graphs(vpool)[("verify", SPEC_K)]
    dcopy = {k: v.clone() for k, v in plain.cache.items()}
    vcopy = {k: v.clone() for k, v in vpool.cache.items()}

    def eager(g, copy, outs, **inputs):
        g.load(**inputs)
        out = g.eager(copy)
        return [out[k].cpu() for k in outs]

    ticks = {
        "decode_replayed": lambda: eng.masked_decode_step(plain),
        "decode_eager": lambda: eager(dgraph, dcopy, ("next", "finite"), tok=plain.tok,
                                      pos=plain.positions(), active=plain.decode_mask()),
        "verify_replayed": lambda: eng.masked_speculative_step(vpool, drafts),
        "verify_eager": lambda: eager(vgraph, vcopy, ("tokens", "accepted", "finite"),
                                      tok=vpool.tok, drafts=drafts, pos=vpool.positions(),
                                      active=vpool.decode_mask()),
    }
    samples = {name: [] for name in ticks}
    for fn in ticks.values():
        fn()
    for i in range(TIMED_TICKS):
        order = list(ticks.items())
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) * 1e3)
    out = {"tick_ms_median": {k: r6(statistics.median(v)) for k, v in samples.items()},
           "tick_ms": {k: [r6(t) for t in v] for k, v in samples.items()},
           "profiled": {k: profile_call(fn) for k, fn in ticks.items()}}
    med = out["tick_ms_median"]
    out["replayed_over_eager"] = {k: r6(med[f"{k}_replayed"] / med[f"{k}_eager"])
                                  for k in ("decode", "verify")}
    # the profiler slows a replay's host path several-fold: the idle share
    # against the unprofiled median is the one a served tick sees
    out["idle_share_of_unprofiled_median"] = {
        k: r6(1.0 - out["profiled"][k]["device_busy_ms"] / med[k]) for k in ticks}
    # a replay alone, back to back, timed by CUDA events: the graph's kernels
    # and the gaps between its nodes, without the tick's host copies and reads
    dgraph.load(tok=plain.tok, pos=plain.positions(), active=plain.decode_mask())
    vgraph.load(tok=vpool.tok, drafts=drafts, pos=vpool.positions(), active=vpool.decode_mask())
    out["replay_only_ms"] = {"decode": r6(time_ms(dgraph.replay, reps=10)),
                             "verify": r6(time_ms(vgraph.replay, reps=10))}

    def synced_ms(fn, n: int = TIMED_TICKS) -> float:
        samples = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return r6(statistics.median(samples))

    # the replayed decode tick piece by piece, each piece alone and synchronised
    out["decode_tick_split_ms"] = {
        "load_inputs": synced_ms(lambda: dgraph.load(tok=plain.tok, pos=plain.positions(),
                                                     active=plain.decode_mask())),
        "one_replay": synced_ms(dgraph.replay),
        "read_outputs": synced_ms(lambda: [dgraph.outputs[k].cpu() for k in ("next", "finite")]),
        "whole_tick": synced_ms(lambda: eng.masked_decode_step(plain))}
    return out


# ---------------------------------------------------------------------------
# serve_paged: the paged KV cache at full width, beside the contiguous pool
# ---------------------------------------------------------------------------
PAGE_SIZE = 16
PAGED_SC = {"max_batch": 4, "max_len": 128, "paged": True, "page_size": PAGE_SIZE}
PREFIX_LEN, PREFIX_TAIL = 64, 16    # a group of 4 prompts sharing a 64-token prefix
SMALL_PAGES = 17                    # 16 allocatable pages: 272 rows, 2 contiguous slots' bytes
SMALL_PROMPT, SMALL_BUDGET = 16, 8  # 2 pages a request
PAGED_SCRIPT = ((0, 5, 10), (1, 9, 6))  # (slot, prompt length, budget) of the reduced configs
PAGED_TIMED_TICKS = 15
PAGED_ARCHS = ("granite-3-8b", "deepseek-v3-671b", "mamba2-780m", "zamba2-7b", "whisper-tiny")


def pool_state(pool, slot: int) -> dict:
    """The slot's state read through its table: each paged leaf's pages of
    positions [0, pos) and each unpaged leaf's row, copied."""
    nb = pool._blocks_for(pool.slots[slot].pos)
    ids = torch.as_tensor(pool.table[slot, :nb].astype(np.int64), device=pool.device)
    return {k: (v.index_select(1, ids) if k in pool._pleaves else v[:, slot]).clone()
            for k, v in pool.cache.items()}


def same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)


def chains_near_tie(want: dict, want_logits: list, got: dict, got_logits: list,
                    what: str) -> dict:
    """The paged chains against the contiguous ones (same prompts, same
    weights, decode ticks from the same prefills).  The two attend over
    different row counts (the paged pool's virtual_len, the contiguous
    pool's capacity): the extra rows weigh exactly 0, but bf16 sums over
    other lengths may round apart in their last bits.  So each slot's chain
    must equal the contiguous one until its first differing token, that
    token a near tie of the contiguous chain's own logits (margin at most
    VERIFY_TIE of the largest |logit|), and until then each tick's logits
    within VERIFY_LOGIT_DIFF of it; the slot is not compared past a flip."""
    worst, flips, equal = 0.0, [], 0
    for s in want:
        if got[s][0] != want[s][0]:
            fail(f"{what}: slot {s}'s prefill gave another first token")
        for j in range(1, min(len(want[s]), len(got[s]))):
            ld, lp = want_logits[j - 1][s], got_logits[j - 1][s]
            scale = float(ld.abs().max())
            worst = max(worst, float((lp - ld).abs().max()) / scale)
            a, b = want[s][j], got[s][j]
            if a != b:
                flips.append({"slot": s, "j": j, "want": a, "got": b,
                              "margin_rel": r6(float(ld[a] - ld[b]) / scale)})
                break
        else:
            equal += 1
    report = {"slots_equal": equal, "slots": len(want), "flips": flips,
              "logits_max_abs_diff_rel": r6(worst), "logits_diff_limit": VERIFY_LOGIT_DIFF,
              "flip_margin_limit": VERIFY_TIE}
    if worst > VERIFY_LOGIT_DIFF or any(f["margin_rel"] > VERIFY_TIE for f in flips):
        fail(f"{what}: paged chains against contiguous: {json.dumps(report)}")
    return report


def tick_kernels(fn) -> dict:
    """{kernel: [device ms, count]} of one call of ``fn`` under the
    profiler (None when no trace held every launch)."""
    from torch.autograd import DeviceType

    fn()
    sample = profiled(fn)
    if sample is None:
        return None
    return {e.key: [e.self_device_time_total / 1e3, e.count] for e in sample[0].key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def paged_tick_costs(contig, cpool, paged, ppool) -> dict:
    """The replayed decode tick of the paged pool beside the contiguous
    pool's (4 live slots each, same weights, same positions): unprofiled
    medians in turns, each profiled once (busy, idle share), and the
    kernels the paged tick runs more of than the contiguous one: its
    gather and scatter, their device time and share of its busy time."""
    ticks = {"contiguous": lambda: contig.masked_decode_step(cpool),
             "paged": lambda: paged.masked_decode_step(ppool)}
    samples = {k: [] for k in ticks}
    for fn in ticks.values():
        fn()
    for i in range(PAGED_TIMED_TICKS):
        for name, fn in (list(ticks.items()) if i % 2 == 0 else list(ticks.items())[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: r6(statistics.median(v)) for k, v in samples.items()}
    prof = {k: profile_call(fn) for k, fn in ticks.items()}
    kern = {k: tick_kernels(fn) for k, fn in ticks.items()}
    out = {"tick_ms_median": med, "tick_ms": {k: [r6(t) for t in v] for k, v in samples.items()},
           "paged_over_contiguous": r6(med["paged"] / med["contiguous"]),
           "profiled": prof,
           "idle_share_of_unprofiled_median": {
               k: r6(1.0 - prof[k]["device_busy_ms"] / med[k]) for k in ticks}}
    if None not in kern.values():
        extra = {}
        for name, (ms, n) in kern["paged"].items():
            c_ms, c_n = kern["contiguous"].get(name, [0.0, 0])
            if n != c_n:
                extra[name[:70]] = [r6(ms - c_ms), n - c_n]
        busy = sum(ms for ms, _ in kern["paged"].values())
        extra_ms = sum(ms for ms, _ in extra.values())
        out["paged_extra_kernels"] = {
            "kernels_a_tick": {k: sum(n for _, n in v.values()) for k, v in kern.items()},
            "busy_ms": {k: r6(sum(ms for ms, _ in v.values())) for k, v in kern.items()},
            "by_kernel": extra, "extra_kernels": sum(n for _, n in extra.values()),
            "extra_ms": r6(extra_ms), "share_of_paged_busy": r6(extra_ms / busy)}
    return out


def gather_scatter_bytes(pool) -> dict:
    """Bytes the paged decode tick's gather and scatter must move: every
    slot's virtual rows of each paged leaf read from the pages and written
    once, and one block a slot read and stored back."""
    per_row = sum(pool.cache[k][:, 0, 0].nbytes for k in pool._pleaves)
    rows = pool.max_batch * pool.virtual_len
    gather = 2 * rows * per_row
    scatter = 2 * pool.max_batch * pool.page * per_row
    return {"gather": gather, "scatter": scatter, "total": gather + scatter,
            "bound_ms": r6((gather + scatter) / PEAK_BYTES_PER_S * 1e3)}


def fork_cow(eng, rng, what: str, alive: list) -> dict:
    """Slot 1 forked from slot 0 (40 prompt tokens): both decode the same
    tokens; the first tick copies the block both write (row 40's) once,
    and the blocks they still share keep their bytes."""
    pool = eng.make_pool()
    alive.append((eng, pool))
    p = rng.integers(0, eng.cfg.vocab_size, 40).astype(np.int32)
    chains = {0: [eng.prefill_into_slot(pool, 0, p, rid=0, budget=ENGINE_BUDGET)]}
    pool.fork_slot(0, 1, rid=1)
    chains[1] = list(chains[0])
    shared = [int(x) for x in pool.table[0, :2]]
    before = {k: pool.cache[k][:, shared].clone() for k in pool._pleaves}
    if [int(pool.pages.refcount[x]) for x in pool.table[0, :3]] != [2, 2, 2]:
        fail(f"{what}: a fork shares its pages: refcounts {pool.pages.refcount.tolist()}")
    decode_chain(eng, pool, chains, 4, f"{what} fork")
    pool.check_invariants()
    kept = all(same_bits(pool.cache[k][:, shared], v) for k, v in before.items())
    if chains[0] != chains[1] or pool.cow_copies != 1 or not kept or \
            [int(x) for x in pool.table[1, :2]] != shared:
        fail(f"{what}: fork: chains {chains}, {pool.cow_copies} copies, shared bytes kept {kept}")
    return {"prompt": 40, "ticks": 4, "cow_copies": pool.cow_copies, "tokens": chains[0],
            "shared_pages_bytes_unchanged": kept}


def shared_prefix_group(params, cfg, rng, what: str, log, alive: list) -> dict:
    """A prompt of PREFIX_LEN + 1 tokens admitted blocking (its 4 full blocks
    registered, then retired), then a group of 4 prompts that share its
    first PREFIX_LEN tokens, chunk-prefilled CHUNK_TOKENS at a time, on a
    pool with prefix sharing and on one without; then 4 ticks.  The shared
    group maps the registered pages and chunks only its tails.  Its first
    tokens (from the last chunk's logits, read from ``log``) and chains are
    held to the unshared group's under the near-tie rule of
    :func:`chains_near_tie`: the shared rows come from a blocking prefill,
    the others from chunks, bf16 sums in other shapes."""
    vocab = cfg.vocab_size
    prefix = rng.integers(0, vocab, PREFIX_LEN + 1).astype(np.int32)
    group = np.stack([np.concatenate([prefix[:PREFIX_LEN],
                                      rng.integers(0, vocab, PREFIX_TAIL).astype(np.int32)])
                      for _ in range(4)])
    runs = {}
    for name, share in (("unshared", False), ("shared", True)):
        eng = engine_mod.InferenceEngine(cfg, params=params, sc=engine_mod.ServeConfig(
            **PAGED_SC, share_prefix=share))
        pool = eng.make_pool()
        alive.append((eng, pool))
        eng.prefill_into_slot(pool, 0, prefix, rid=9, budget=4)
        pool.retire(0)
        st = eng.begin_chunked_prefill(pool, [0, 1, 2, 3], group, rids=[0, 1, 2, 3],
                                       budgets=[ENGINE_BUDGET] * 4)
        steps = 0
        while not st.done:
            eng.chunked_prefill_step(st, CHUNK_TOKENS)
            steps += 1
        last_chunk = log.calls[-1]["logits"][:, :vocab].float().cpu()
        first = eng.finish_chunked_prefill(pool, st)
        chains, logits = {j: [int(first[j])] for j in range(4)}, [last_chunk]
        decode_chain(eng, pool, chains, 4, f"{what} prefix group", logits)
        pool.check_invariants()
        runs[name] = {"chunk_steps": steps, "shared_hit_pages": pool.shared_hit_pages,
                      "chains": {j: [-1] + c for j, c in chains.items()}, "logits": logits}
    sh, un = runs["shared"], runs["unshared"]
    if (sh["chunk_steps"], un["chunk_steps"]) != (PREFIX_TAIL // CHUNK_TOKENS,
                                                  (PREFIX_LEN + PREFIX_TAIL) // CHUNK_TOKENS) \
            or sh["shared_hit_pages"] != 4 * PREFIX_LEN // PAGE_SIZE:
        fail(f"{what}: prefix group: {sh['chunk_steps']} / {un['chunk_steps']} chunk steps, "
             f"{sh['shared_hit_pages']} shared pages")
    # each chain led by a placeholder, so that the first token is held to the
    # last chunk's logits as the others are to their ticks'
    near = chains_near_tie(un["chains"], un["logits"], sh["chains"], sh["logits"],
                           f"{what} prefix group")
    return {"group": list(group.shape), "prefix": PREFIX_LEN, "chunk_tokens": CHUNK_TOKENS,
            "chunk_steps": {"shared": sh["chunk_steps"], "unshared": un["chunk_steps"]},
            "shared_hit_pages": sh["shared_hit_pages"], "chains_vs_unshared": near,
            "tokens": {k: {s: c[1:] for s, c in r["chains"].items()} for k, r in runs.items()}}


def int8_kv_pool(params, cfg, prompts, what: str, alive: list) -> dict:
    """A pool of int8 KV pages: the four prompts, 4 replayed ticks, finite.
    Then one tick's gather and decode run eagerly on a copy of the cache,
    and the blocks it quantizes are quantized on the card and on the CPU:
    the same bytes (payloads and scales)."""
    from repro_torch.models.model import paged_written_blocks
    from repro_torch.serving.kv_cache import quantize_kv

    eng = engine_mod.InferenceEngine(cfg, params=params, sc=engine_mod.ServeConfig(
        **PAGED_SC, kv_quant="int8"))
    pool = eng.make_pool()
    alive.append((eng, pool))
    chains = {s: [eng.prefill_into_slot(pool, s, p, rid=s, budget=ENGINE_BUDGET)]
              for s, p in enumerate(prompts)}
    decode_chain(eng, pool, chains, 4, f"{what} int8 KV")
    g = eng.step_graphs(pool)[("decode", 0)]
    g.load(tok=pool.tok, pos=pool.positions(), active=pool.decode_mask(), table=pool.table)
    copy = {k: v.clone() for k, v in pool.cache.items()}
    with torch.inference_mode():
        virt = eng._paged_gather(copy, g.inputs["table"])
        eng._decode_tick(virt, g.inputs["tok"], g.inputs["pos"], g.inputs["active"])
    rows, equal = 0, True
    for key in pool._pkeys:
        w = paged_written_blocks(virt[key], g.inputs["pos"] // PAGE_SIZE, 1, PAGE_SIZE)
        qc, sc = quantize_kv(w)
        qh, sh = quantize_kv(w.cpu())
        equal = equal and same_bits(qc.cpu(), qh) and same_bits(sc.cpu(), sh)
        rows += sc.numel()
    if not equal:
        fail(f"{what}: quantize_kv on the card differs from the CPU on the tick's rows")
    page_bytes = {k: pool.cache[k].nbytes for k in pool._pleaves}
    return {"ticks": 4, "tokens": chains, "quantized_rows": rows,
            "card_equals_cpu_bytes": True, "page_leaf_bytes": page_bytes,
            "payload_dtype": str(pool.cache[pool._pkeys[0]].dtype)}


def swap_round_trip(pool, slot: int, what: str) -> dict:
    """``swap_out`` of a decoding slot and ``swap_in`` into the same slot:
    its pages (read through its new table row) and rows bit for bit."""
    want = pool_state(pool, slot)
    est = pool.swap_image_bytes(slot)
    image = pool.swap_out(slot)
    pool.check_invariants()
    pool.swap_in(slot, image)
    pool.check_invariants()
    torch.cuda.synchronize()
    equal = same_state(pool_state(pool, slot), want)
    if not equal or image["bytes"] != est:
        fail(f"{what}: swap round trip equal {equal}, {image['bytes']} bytes against {est}")
    return {"slot": slot, "pos": pool.slots[slot].pos, "bytes": image["bytes"],
            "bitwise_equal": True}


def small_pool(params, cfg, rng, what: str, alive: list) -> dict:
    """A pool of SMALL_PAGES pages, fewer than the contiguous worst case
    (4 x max_blocks + 1): its bytes hold 2 contiguous slots of 128 rows,
    and it serves 4 requests of SMALL_PROMPT tokens to their budget.  Its
    allocation is ``paged_cache_bytes``."""
    from repro_torch.serving.kv_cache import cache_bytes, paged_cache_bytes

    eng = engine_mod.InferenceEngine(cfg, params=params, sc=engine_mod.ServeConfig(
        **PAGED_SC, num_pages=SMALL_PAGES))
    pool = eng.make_pool()
    alive.append((eng, pool))
    allocated = sum(v.nbytes for v in pool.cache.values()) + pool.table.nbytes
    want = paged_cache_bytes(cfg, batch=4, num_pages=SMALL_PAGES, page_size=PAGE_SIZE,
                             max_blocks=pool.max_blocks)
    per_slot = cache_bytes(cfg, batch=1, max_len=PAGED_SC["max_len"])
    chains = {}
    for s in range(4):
        if not pool.can_admit(SMALL_PROMPT, SMALL_BUDGET):
            fail(f"{what}: the small pool refused request {s}")
        p = rng.integers(0, cfg.vocab_size, SMALL_PROMPT).astype(np.int32)
        chains[s] = [eng.prefill_into_slot(pool, s, p, rid=s, budget=SMALL_BUDGET)]
    while pool.active_count:
        decode_chain(eng, pool, chains, 1, f"{what} small pool")
        for s in pool.decoding_slots():
            if pool.slots[s].emitted >= pool.slots[s].budget:
                pool.retire(s)
    pool.check_invariants()
    if allocated != want or allocated // per_slot >= 4 or \
            any(len(c) != SMALL_BUDGET for c in chains.values()):
        fail(f"{what}: small pool: {allocated} bytes against paged_cache_bytes {want}, "
             f"{allocated // per_slot} contiguous slots' worth, chains {chains}")
    return {"num_pages": SMALL_PAGES, "contiguous_worst_case_pages": 4 * pool.max_blocks + 1,
            "allocated_bytes": allocated, "paged_cache_bytes": want,
            "contiguous_slot_bytes": per_slot, "contiguous_slots_in_these_bytes":
                allocated // per_slot, "requests_served": 4}


def paged_script(eng) -> dict:
    """The CPU tests' script (``tests/test_torch_paged_serving.py``): two
    requests admitted, 4 ticks, one retired early and its slot given a third,
    5 more ticks; chains by rid."""
    rng = np.random.default_rng(7)
    pool = eng.make_pool()
    chains = {}
    for slot, n, budget in PAGED_SCRIPT:
        p = rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32)
        chains[slot] = [eng.prefill_into_slot(pool, slot, p, rid=slot, budget=budget)]

    def ticks(n):
        for _ in range(n):
            live = pool.decode_mask().copy()
            nxt, fin = eng.masked_decode_step(pool)
            if not fin[live].all():
                fail(f"paged reduced {eng.cfg.name}: a decoding slot read non-finite")
            for s in map(int, np.flatnonzero(live)):
                pool.advance(s, 1, int(nxt[s]))
                chains[pool.slots[s].rid].append(int(nxt[s]))
                if pool.slots[s].emitted >= pool.slots[s].budget:
                    pool.retire(s)

    ticks(4)
    pool.retire(0)
    p = rng.integers(0, eng.cfg.vocab_size, 7).astype(np.int32)
    chains[2] = [eng.prefill_into_slot(pool, 0, p, rid=2, budget=8)]
    ticks(5)
    return chains


def reduced_paged_identity(dev) -> dict:
    """The reduced configs of the five cache layouts in f32, full-precision
    weights, on the card: the paged engine's chains equal the contiguous
    engine's, token for token."""
    out = {}
    for arch in PAGED_ARCHS:
        cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32, quant=None)
        params = tree_map(lambda t: t.float(), init_model(cfg, torch.Generator(dev).manual_seed(0),
                                                          dev))
        chains = {}
        for name, extra in (("contiguous", {}), ("paged", {"paged": True, "page_size": 4})):
            eng = engine_mod.InferenceEngine(cfg, params=params, sc=engine_mod.ServeConfig(
                max_batch=2, max_len=32, **extra))
            chains[name] = paged_script(eng)
        if chains["paged"] != chains["contiguous"]:
            fail(f"paged reduced {arch}: {chains['paged']} != contiguous {chains['contiguous']}")
        out[arch] = {"tokens_identical": True, "tokens": chains["paged"]}
    return out


def plain_and_verify(eng, what: str) -> dict:
    """:func:`verify_steps`' work, keeping what the paged path compares: the
    plain chain of SPEC_PROMPTS (CHAIN_TICKS decode ticks) with its logits,
    and the teacher-forced verify ticks from the same prefills."""
    vocab = eng.cfg.vocab_size
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in SPEC_PROMPTS]
    plain = eng.make_pool()
    chain = {s: [eng.prefill_into_slot(plain, s, p, rid=s, budget=ENGINE_BUDGET)]
             for s, p in enumerate(prompts)}
    logits = []
    decode_chain(eng, plain, chain, CHAIN_TICKS, f"{what} plain chain", logits)
    vpool = eng.make_pool()
    for s, p in enumerate(prompts):
        if eng.prefill_into_slot(vpool, s, p, rid=s, budget=ENGINE_BUDGET) != chain[s][0]:
            fail(f"{what}: the same prefill gave another first token")
    spec, drafts = forced_verify(eng, vpool, chain, logits, what)
    return {"prompts": prompts, "plain": plain, "vpool": vpool, "logits": logits,
            "chain": chain, "decoded": {s: list(c) for s, c in chain.items()},
            "speculative": spec, "drafts": drafts}


def drive_serve_paged(dev, base) -> dict:
    """The paged KV cache at full width: serve_dense's int8 granite-3-8b
    weights through a paged engine (``PAGED_SC``) beside a contiguous one
    (``ENGINE_SC``), then the reduced configs of the five cache layouts."""
    cfg, params = base.cfg, base.params
    contig = engine_mod.InferenceEngine(cfg, params=params,
                                        sc=engine_mod.ServeConfig(**ENGINE_SC))
    paged = engine_mod.InferenceEngine(cfg, params=params, sc=engine_mod.ServeConfig(**PAGED_SC))
    per_call, report, alive = 7 * cfg.num_layers, {}, []
    with CallLog() as log:
        c_run, p_run = plain_and_verify(contig, "serve_paged contiguous"), \
            plain_and_verify(paged, "serve_paged")
        ppool = p_run["plain"]
        for eng, run in ((contig, c_run), (paged, p_run)):
            alive += [(eng, run["plain"]), (eng, run["vpool"])]
        report["pool"] = {"max_batch": 4, "max_len": 128, "page_size": PAGE_SIZE,
                          "num_pages": ppool.num_pages, "max_blocks": ppool.max_blocks,
                          "virtual_len": ppool.virtual_len,
                          "contiguous_capacity": c_run["plain"].capacity}
        report["chains_vs_contiguous"] = chains_near_tie(
            c_run["decoded"], c_run["logits"], p_run["decoded"], p_run["logits"], "serve_paged")
        report["speculative"] = p_run["speculative"]
        report["graph_vs_eager"] = ticks_vs_eager(paged, ppool, p_run["vpool"], p_run["drafts"],
                                                  "serve_paged")
        report["ticks"] = paged_tick_costs(contig, c_run["plain"], paged, ppool)
        report["gather_scatter_bytes"] = gather_scatter_bytes(ppool)
        report["fork_cow"] = fork_cow(paged, np.random.default_rng(41), "serve_paged", alive)
        report["swap"] = swap_round_trip(ppool, 2, "serve_paged")
        for k in ppool._pleaves:  # a finite mark, weighed 0 where it is gathered
            ppool.cache[k][:, SCRATCH] = 1
        report["poison_resume"] = poison_resume(paged, ppool, p_run["prompts"], p_run["chain"],
                                                "serve_paged")
        if any(bool(ppool.cache[k][:, SCRATCH].any()) for k in ppool._pleaves):
            fail("serve_paged: the scratch page was not zeroed after the flagged tick")
        report["poison_resume"]["scratch_zeroed"] = True
        report["shared_prefix"] = shared_prefix_group(params, cfg, np.random.default_rng(42),
                                                      "serve_paged", log, alive)
        report["int8_kv"] = int8_kv_pool(params, cfg, p_run["prompts"], "serve_paged", alive)
        report["small_pool"] = small_pool(params, cfg, np.random.default_rng(43), "serve_paged",
                                          alive)
        report["reduced_identity"] = reduced_paged_identity(dev)
    log.check("serve_paged")
    graphs = [g for eng, p in alive for g in eng.step_graphs(p).values()]
    for g in graphs:
        if g.launches.get("int8_matmul") != per_call:
            fail(f"serve_paged: a graph holds {g.launches} launches, {per_call} int8_matmul "
                 "expected")
    report["int8_matmul_a_replay"] = {
        name: sorted({g.launches.get("int8_matmul") for p in pools
                      for g in eng.step_graphs(p).values()})
        for name, eng, pools in (("contiguous", contig, (c_run["plain"], c_run["vpool"])),
                                 ("paged", paged, (ppool, p_run["vpool"])))}
    replayed = sum(g.replays * g.launches.get("int8_matmul", 0) for g in graphs)
    report.update(calls=len(log.calls), graphs=len(graphs),
                  replays=sum(g.replays for g in graphs), int8_matmul_per_call=per_call)
    return {"expect": {"int8_matmul": sum(c["per_call"] for c in log.calls) + replayed},
            "report": report}


def _quant_leaves(tree):
    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, QuantTensor) else None, tree)
    return out


def check_block_card_vs_cpu(eng, dev, stack: str = "blocks",
                            body=transformer.dense_block_prefill, layered: bool = True) -> dict:
    """Layer 0 of ``stack`` of the int8 engine (``stack`` itself where it is
    not ``layered``, as zamba2's one shared block), one full-width block
    (``body``, a prefill body returning (out, cache rows)), on the card and
    on the CPU from the same weights and a 16-token prompt: the output and
    the first cache leaf held to each other."""
    cfg = eng.cfg
    p_card = tree_map(lambda t: layer_of(t, 0), eng.params[stack]) if layered else \
        eng.params[stack]
    p_cpu = tree_map(lambda t: QuantTensor(t.q.cpu(), t.scale.cpu())
                     if isinstance(t, QuantTensor) else t.cpu(), p_card)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 16)))
    x = eng.params["embed"]["tokens"][toks.to(dev)]
    with torch.inference_mode():
        y_card, rows_card = body(p_card, x, cfg)
        y_cpu, rows_cpu = body(p_cpu, x.cpu(), cfg)
    k_card, k_cpu = rows_card[0], rows_cpu[0]  # the first cache leaf: K, c or the conv tail
    worst = {}
    for name, got, want in (("out", y_card, y_cpu), ("cache", k_card, k_cpu)):
        got, want = got.float().cpu(), want.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"block card vs cpu: non-finite {name}")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        mean = float((got - want).abs().mean())
        if err > BLOCK_TOL * scale or mean > BLOCK_MEAN_TOL * scale:
            fail(f"block card vs cpu ({cfg.name} {body.__name__}): {name} max err {err:.3e}, "
                 f"mean {mean:.3e}, over {BLOCK_TOL} / {BLOCK_MEAN_TOL} x {scale:.3e}")
        worst[name] = {"max_abs_err": r6(err), "max_abs": r6(scale), "mean_abs_err": r6(mean)}
    return {"config": cfg.name, "block": body.__name__, "tokens": 16,
            "tolerance": f"max {BLOCK_TOL}, mean {BLOCK_MEAN_TOL} x max|cpu|", **worst}


def generate_and_slots(eng, prompts, rng, what: str, report: dict):
    """``generate`` of ``prompts`` (GEN_NEW tokens) and the slot path, into
    ``report``.  Returns (the slot pool, generate's tokens)."""
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, GEN_NEW)
    report["generate"] = {"prompts": GEN_PROMPTS, "prompt_len": GEN_LEN,
                          "new_tokens": GEN_NEW, "seconds": r6(time.perf_counter() - t0)}
    pool, slot_tokens, tick_ms, slot_finite = slot_path(eng, rng)
    if not slot_finite:
        fail(f"{what}: masked_decode_step flagged a live slot non-finite")
    report["slots"] = {"max_batch": 4, "max_len": eng.sc.max_len,
                       "prompts": [image_rows(eng) + n for n in SLOT_PROMPTS],
                       "tick_ms_median": r6(statistics.median(tick_ms[1:])),
                       "tokens": slot_tokens}
    return pool, tokens


def chunked_group(eng, rng, what: str, report: dict, chunk_tokens: int = CHUNK_TOKENS):
    """A group of 2 prompts of GROUP_LEN tokens (after the image rows)
    prefilled in chunks of ``chunk_tokens`` while slots 2 and 3 decode, then
    two ticks of all four.  Returns the pool."""
    vocab, lead = eng.cfg.vocab_size, image_rows(eng)
    cpool = eng.make_pool()
    chains = {2 + i: [eng.prefill_into_slot(cpool, 2 + i, p, rid=2 + i, budget=ENGINE_BUDGET)]
              for i, p in enumerate(rng.integers(0, vocab, lead + n).astype(np.int32)
                                    for n in DECODING_PROMPTS)}
    group = rng.integers(0, vocab, (2, lead + GROUP_LEN)).astype(np.int32)
    st = eng.begin_chunked_prefill(cpool, [0, 1], group, rids=[0, 1],
                                   budgets=[ENGINE_BUDGET] * 2)
    chunks = 0
    while not st.done:
        eng.chunked_prefill_step(st, chunk_tokens)
        chunks += 1
        decode_chain(eng, cpool, chains, 1, f"{what} chunked prefill")
    first = eng.finish_chunked_prefill(cpool, st)
    chains.update({j: [int(first[j])] for j in range(2)})
    decode_chain(eng, cpool, chains, 2, f"{what} after the group")
    report["chunked_prefill"] = {"group": list(group.shape), "chunk_tokens": chunk_tokens,
                                 "chunk_calls": chunks, "first_tokens": first.tolist()}
    return cpool


def verify_steps(eng, rng, what: str, report: dict):
    """The plain chain of SPEC_PROMPTS (after the image rows; CHAIN_TICKS
    decode ticks) and, from the same prefills, the teacher-forced verify
    ticks (:func:`forced_verify`).  Returns (plain pool, verify pool,
    prompts, chain, the last drafts)."""
    vocab, lead = eng.cfg.vocab_size, image_rows(eng)
    prompts = [rng.integers(0, vocab, lead + n).astype(np.int32) for n in SPEC_PROMPTS]
    plain = eng.make_pool()
    chain = {s: [eng.prefill_into_slot(plain, s, p, rid=s, budget=ENGINE_BUDGET)]
             for s, p in enumerate(prompts)}
    chain_logits = []
    decode_chain(eng, plain, chain, CHAIN_TICKS, f"{what} plain chain", chain_logits)
    vpool = eng.make_pool()
    for s, p in enumerate(prompts):
        if eng.prefill_into_slot(vpool, s, p, rid=s, budget=ENGINE_BUDGET) != chain[s][0]:
            fail(f"{what}: the same prefill gave another first token")
    report["speculative"], drafts = forced_verify(eng, vpool, chain, chain_logits, what)
    return plain, vpool, prompts, chain, drafts


def poison_resume(eng, plain, prompts, chain, what: str) -> dict:
    """Poison slot 1 of ``plain`` (decoding ``chain``), see it alone flagged,
    quarantine it, resume it from its committed context, two more ticks."""
    eng.poison_slot(plain, 1)
    nxt, fin = eng.masked_decode_step(plain)
    if fin[1] or not fin[[0, 2, 3]].all():
        fail(f"{what}: after poisoning slot 1, finite {fin}")
    for s in (0, 2, 3):
        plain.advance(s, 1, int(nxt[s]))
        chain[s].append(int(nxt[s]))
    plain.retire(1)
    context = np.concatenate([prompts[1], np.asarray(chain[1][:-1], np.int32)])
    eng.resume_into_slot(plain, 1, context, rid=1, budget=ENGINE_BUDGET,
                         emitted=len(chain[1]), next_tok=chain[1][-1])
    resumed = {s: [] for s in range(4)}
    decode_chain(eng, plain, resumed, 2, f"{what} after resume")
    return {"finite_after_poison": fin.tolist(), "resumed_tokens": resumed[1]}


def ticks_vs_eager(eng, plain, vpool, drafts, what: str) -> dict:
    """:func:`graph_vs_eager` for the decode tick of ``plain`` and the verify
    tick of ``vpool``."""
    dgraph = eng.step_graphs(plain)[("decode", 0)]
    vgraph = eng.step_graphs(vpool)[("verify", SPEC_K)]

    def table(g, pool):  # a paged pool's ticks take its page table too
        return {"table": pool.table} if "table" in g.inputs else {}

    return {"decode": graph_vs_eager(dgraph, f"{what} decode tick", tok=plain.tok,
                                     pos=plain.positions(), active=plain.decode_mask(),
                                     **table(dgraph, plain)),
            "verify": graph_vs_eager(vgraph, f"{what} verify tick", tok=vpool.tok,
                                     drafts=drafts, pos=vpool.positions(),
                                     active=vpool.decode_mask(), **table(vgraph, vpool))}


def graph_launches(graphs, cfg, what: str) -> int:
    """Every graph holds ``k5_per_call`` int8_matmul launches of its kind;
    returns the launches their replays ran."""
    for g in graphs:
        kind = "decode_verify" if "drafts" in g.inputs else "decode_step"
        if g.launches.get("int8_matmul") != k5_per_call(cfg, kind):
            fail(f"{what}: a {kind} graph holds {g.launches} launches, "
                 f"{k5_per_call(cfg, kind)} int8_matmul expected")
    return sum(g.replays * g.launches.get("int8_matmul", 0) for g in graphs)


def twin_agreement(full, prompts, tokens, what: str) -> float:
    """Greedy-chain agreement of ``tokens`` with the bf16 twin's ``generate``
    of the same prompts, held to AGREEMENT_FLOOR."""
    agreement = float((tokens == full.generate(prompts, GEN_NEW)).mean())
    if agreement < AGREEMENT_FLOOR:
        fail(f"{what}: greedy-chain agreement {agreement:.3f} with the bf16 engine, "
             f"under the floor {AGREEMENT_FLOOR}")
    return agreement


# ---------------------------------------------------------------------------
# serve_moe: the moe family at full width, the expert einsums one K5 launch
# over the expert axis
# ---------------------------------------------------------------------------
MOE = "granite-moe-3b-a800m"        # full width, full depth (32 layers)
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_LAYERS = 2                 # the only cut: 61 → 2 layers, one MLA-dense, one MLA-MoE
# Verify's agreement with plain decode on the moe family, below the dense
# engine's 0.95: both configs read 0.9375-0.953 over 64 positions (H100
# 80GB HBM3, 700 W), every flip at a near tie (VERIFY_TIE): bf16 rounding
# that differs between the window and single steps moves a router near its
# top-k edge (gaps of 1e-5 to 3e-3 in probability) or a logit near a tie.
# 0.85 leaves room for that rate's spread (~3.5 flips of 64) and fails a
# verify wrong at one position in six.  internvl2-76b (8 layers at full
# width, vocab 128256) reads the same: 0.922-1.0 over seven prompt draws,
# mean 0.973, every flip at a chain margin of 0-2.1% (1-3 bf16 ulps of its
# logits; ``agreement_check.py``'s six draws and this script's own, same
# card), and 0.906 once decode runs K7 (decode and verify then sum in other
# orders; every flip at a margin of 0-2.3%), so the vlm takes this floor.
MOE_VERIFY_FLOOR = 0.85


def twin_engines(dev, cfg_f, sc: dict = ENGINE_SC):
    """The int8 engine and its bf16 twin over the same random weights (seed
    0, attention at the standard fan-in), with ``spec_slack`` for verify."""
    params = init_model(cfg_f, torch.Generator(device=dev).manual_seed(0), dev)
    standard_fan_in(params, cfg_f)
    sc = engine_mod.ServeConfig(**sc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = engine_mod.InferenceEngine(dataclasses.replace(cfg_f, quant="int8"), params=params,
                                     sc=sc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    return eng, engine_mod.InferenceEngine(cfg_f, params=params, sc=sc), init_s


def serve_moe_config(dev, arch: str, layers: int | None) -> dict:
    """One config of the moe family through the int8 engine: ``generate``,
    the slot path (replayed ticks), a chunked prefill while two slots
    decode, verify ticks teacher-forced from the plain chain (as
    ``serve_engine``'s); the replayed ticks against the eager ones; greedy agreement
    with the bf16 engine on the same weights; one block on the card against
    the CPU (its launches recorded apart, not counted)."""
    t_start = time.perf_counter()
    cfg_f = get_config(arch)
    if layers is not None:
        cfg_f = dataclasses.replace(cfg_f, num_layers=layers, first_k_dense=min(
            cfg_f.first_k_dense, layers - 1))
    torch.cuda.reset_peak_memory_stats()
    eng, full, init_s = twin_engines(dev, cfg_f)
    cfg, vocab = eng.cfg, cfg_f.vocab_size
    rng = np.random.default_rng(60)
    prompts = rng.integers(0, vocab, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    report = {"arch": arch, "layers": cfg.num_layers, "of_layers": get_config(arch).num_layers,
              "first_k_dense": cfg.first_k_dense, "dtype": "bfloat16", "quant": "int8",
              "int8_weight_bytes": sum(t.q.numel() for t in _quant_leaves(eng.params)),
              "quantize_at_init_s": r6(init_s)}
    what = f"serve_moe {arch}"
    with CallLog() as log:
        pool, tokens_q = generate_and_slots(eng, prompts, rng, what, report)
        # where a replayed tick's time goes: K5 against the bytes it must read
        tick = profile_call(lambda: eng.masked_decode_step(pool))
        k5_bytes = sum(t.q.numel() + 4 * t.scale.numel()
                       for stack in ("dense_blocks", "blocks") if stack in eng.params
                       for t in _quant_leaves(eng.params[stack]))
        report["decode_tick_profile"] = {
            **tick, "int8_weight_bytes_a_tick": k5_bytes,
            "int8_matmul_bound_ms": r6(k5_bytes / PEAK_BYTES_PER_S * 1e3),
            "int8_matmul_share_of_busy": r6(tick["int8_matmul_device_ms"]
                                            / tick["device_busy_ms"])}
        cpool = chunked_group(eng, rng, what, report)
        plain, vpool, _, _, drafts = verify_steps(eng, rng, what, report)
        report["graph_vs_eager"] = ticks_vs_eager(eng, plain, vpool, drafts, what)
        graphs = [g for p in (pool, cpool, plain, vpool) for g in eng.step_graphs(p).values()]
    log.check(what)
    replayed = graph_launches(graphs, cfg, what)
    agreement = twin_agreement(full, prompts, tokens_q, what)
    stack, body = (("blocks", transformer.dense_block_prefill) if cfg.mla is None
                   else ("dense_blocks", transformer.mla_block_prefill))
    with runtime.launches_recorded() as block_launches:  # a module check, not the path
        report["block_card_vs_cpu"] = check_block_card_vs_cpu(eng, dev, stack, body)
    want = k5_per_call(dataclasses.replace(cfg, num_layers=1, first_k_dense=cfg.first_k_dense
                                           and 1), "prefill")
    if block_launches.get("int8_matmul") != want:
        fail(f"serve_moe {arch}: the block on the card launched {block_launches}, "
             f"{want} int8_matmul expected")
    report["block_card_vs_cpu"]["int8_matmul_launches"] = want
    decode_ms = [c["ms"] for c in log.calls if c["kind"] == "decode_step"]
    report.update({
        "int8_matmul_per_call": {k: k5_per_call(cfg, k) for k in
                                 ("prefill", "decode_step", "prefill_chunk", "decode_verify")},
        "calls": len(log.calls), "graphs": len(graphs),
        "replays": sum(g.replays for g in graphs),
        "eager_decode_ms_median": r6(statistics.median(decode_ms)),
        "greedy_agreement_vs_bf16": r6(agreement), "agreement_floor": AGREEMENT_FLOOR,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "seconds": r6(time.perf_counter() - t_start)})
    return {"int8_matmul": sum(c["per_call"] for c in log.calls) + replayed, "report": report}


def drive_serve_moe(dev) -> dict:
    """granite-moe-3b-a800m at full width and depth, then (its engines
    freed) deepseek-v3-671b at full width and 2 layers, then the reduced
    configs of both in f32, token for token: granite-moe with int8 weights
    chunked == blocking and speculative == plain; deepseek both with
    full-precision weights, and speculative == plain with int8 weights."""
    moe = serve_moe_config(dev, MOE, None)
    torch.cuda.empty_cache()
    deepseek = serve_moe_config(dev, DEEPSEEK, DEEPSEEK_LAYERS)
    torch.cuda.empty_cache()
    report = {"granite_moe": moe["report"], "deepseek": deepseek["report"], "strict_identity": {}}
    expect = moe["int8_matmul"] + deepseek["int8_matmul"]
    for arch, quant in ((MOE, "int8"), (DEEPSEEK, None), (DEEPSEEK, "int8")):
        report["strict_identity"][f"{arch} {quant or 'f32'}"], launched = strict_identity_logged(
            dev, arch, f"serve_moe strict identity {arch} {quant}", quant)
        expect += launched
    return {"expect": {"int8_matmul": expect}, "report": report}


# ---------------------------------------------------------------------------
# serve_ssm: the ssm and hybrid families at full width and full depth
# ---------------------------------------------------------------------------
SSM_ARCHS = ("mamba2-780m", "zamba2-7b")  # full width, full depth: 48 and 81 Mamba2 layers
LONG_PROMPT, LONG_CHUNK = 512, 64       # two of the 256-token SSD chunks; its composition in 64s
# The long prompt's blocking prefill against its chunked composition, bf16
# with int8 weights, per leaf: the two sum the same recurrence in other
# orders and round to bf16 after every layer, and a last-bit difference can
# move an activation across an int8 rounding edge; over 48-81 layers that
# drift is the noise (the reduced zamba2 in bf16 on the CPU: logits max 7.5%,
# mean 1.7% of the largest; shared K/V max 14%, mean 0.8%).  A wrong carry of
# the state or the conv tail moves them by their own size.  Max within
# VERIFY_LOGIT_DIFF, mean within 0.02 (the int8 mean rule of the CPU tests)
# of the largest magnitude.
LONG_TOL, LONG_MEAN_TOL = VERIFY_LOGIT_DIFF, 0.02


def shared_block_prefill(p, x, cfg):
    """zamba2's shared attention block over a prompt, ``x`` also its x0 (the
    first application, where the block's input is the embedding)."""
    return transformer.shared_attn_prefill(p, x, x, cfg)


def held(got: torch.Tensor, want: torch.Tensor, what: str, tol: float, mean_tol: float) -> dict:
    """Max and mean |got - want| against ``tol`` / ``mean_tol`` times the
    largest |want|; fails past either."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite values")
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    mean = float((got - want).abs().mean())
    if err > tol * scale or mean > mean_tol * scale:
        fail(f"{what}: max err {err:.3e}, mean {mean:.3e}, over {tol} / {mean_tol} x {scale:.3e}")
    return {"max_abs_err": r6(err), "mean_abs_err": r6(mean), "max_abs": r6(scale)}


def tree_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tensors and ``QuantTensor`` leaves (a
    ``QuantTensor`` gives its payload and its scales)."""
    return [x for leaf in tree_leaves(tree)
            for x in (leaf if isinstance(leaf, QuantTensor) else (leaf,))]


def tree_bytes(tree) -> int:
    """Device bytes of a tree of tensors and ``QuantTensor`` leaves."""
    return sum(x.numel() * x.element_size() for x in tree_tensors(tree))


def ssm_tick_bytes(eng, pool) -> dict:
    """Bytes one decode tick of the pool must move: every weight once (the
    shared block once per application, the unembedding: the tied table for
    mamba2), the (conv, state) of every layer read and written, and the
    shared K/V read over the pool's capacity."""
    cfg, p = eng.cfg, eng.params
    apps = math.ceil(cfg.num_layers / cfg.attn_every) if "shared" in p else 0
    unembed = p["embed"].get("unembed", p["embed"]["tokens"])
    weights = {"mamba_layers": tree_bytes(p["blocks"]),
               "shared_block_x_applications": apps * tree_bytes(p.get("shared", {})),
               "unembedding": tree_bytes(unembed)}
    state = {"conv_and_state_read_and_written": 2 * tree_bytes(
        [pool.cache["conv"], pool.cache["state"]]),
        "shared_kv_read": tree_bytes([pool.cache[k] for k in pool.cache
                                      if k.startswith("shared")])}
    total = sum(weights.values()) + sum(state.values())
    return {"weights": weights, "state": state, "total": total,
            "bound_ms": r6(total / PEAK_BYTES_PER_S * 1e3), "bound_by": "bytes"}


def snapshot_bytes(cfg, batch: int, window: int) -> dict:
    """What a verify window of ``window`` tokens keeps for the rollback, at
    ``batch`` slots: the reference's per-position snapshots of every layer
    (state f32, conv tail in the cache's type), and the port's
    ``ssm.VerifyCarry`` (the raw window in the cache's type; cum, dt·x and B
    in f32)."""
    s, layers = cfg.ssm, cfg.num_layers
    h, p, n, w = s.num_heads(cfg.d_model), s.head_dim, s.state_size, s.conv_width
    c, item = s.d_inner(cfg.d_model) + 2 * n, cfg.dtype.itemsize
    carry = batch * ((w - 1 + window) * c * item + window * (h + h * p + n) * 4)
    return {"batch": batch, "window": window,
            "reference_state_snapshots": layers * batch * window * h * p * n * 4,
            "reference_conv_snapshots": layers * batch * window * (w - 1) * c * item,
            "verify_carry": layers * carry}


def long_prompt(eng, dev) -> dict:
    """One prompt of ``LONG_PROMPT`` tokens through ``prefill`` (two SSD
    chunks of 256: the inter-chunk scan at full width) and the same prompt
    as chunked prefill in chunks of ``LONG_CHUNK``, both through the
    engine's model calls (logged and counted): the last logits and every
    cache leaf held to each other (``LONG_TOL``)."""
    cfg = eng.cfg
    toks = torch.as_tensor(np.random.default_rng(71).integers(0, cfg.vocab_size, (
        1, LONG_PROMPT)), device=dev)
    with torch.inference_mode():
        logits, cache = engine_mod.prefill(eng.params, toks, cfg)
        chunked = init_params(cache_defs(cfg, batch=1, max_len=LONG_PROMPT), torch.Generator(),
                              dev)
        for pos in range(0, LONG_PROMPT, LONG_CHUNK):
            clog, chunked = engine_mod.prefill_chunk(eng.params, chunked,
                                                     toks[:, pos:pos + LONG_CHUNK], pos, cfg)
    vocab = cfg.vocab_size
    out = {"tokens": LONG_PROMPT, "ssd_chunk": cfg.ssm.chunk_size, "chunk_tokens": LONG_CHUNK,
           "tolerance": f"max {LONG_TOL}, mean {LONG_MEAN_TOL} x max|blocking|",
           "last_logits": held(clog[:, :vocab], logits[:, :vocab], f"serve_ssm {cfg.name} long "
                               "prompt logits", LONG_TOL, LONG_MEAN_TOL),
           "argmax_blocking": int(logits[0, :vocab].argmax()),
           "argmax_chunked": int(clog[0, :vocab].argmax())}
    for key, t in cache.items():
        out[key] = held(chunked[key], t, f"serve_ssm {cfg.name} long prompt cache {key!r}",
                        LONG_TOL, LONG_MEAN_TOL)
    return out


def serve_ssm_config(dev, arch: str) -> dict:
    """One config of the ssm or hybrid family at full width and depth through
    the int8 engine: ``generate``, the slot path (replayed ticks, timed and
    profiled beside the bytes a tick must move), a chunked prefill while two
    slots decode, verify ticks teacher-forced from the plain chain (each row
    rolled back to its own accepted count), poison → quarantine → resume, the
    replayed ticks against the eager ones, the long prompt's two-chunk scan
    against its chunked composition; greedy agreement with the bf16 engine
    on the same weights; one Mamba2 block (and zamba2's shared block) on the
    card against the CPU."""
    t_start = time.perf_counter()
    cfg_f = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    eng, full, init_s = twin_engines(dev, cfg_f)
    cfg, vocab = eng.cfg, cfg_f.vocab_size
    rng = np.random.default_rng(70)
    prompts = rng.integers(0, vocab, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    report = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
              "of_layers": get_config(arch).num_layers,
              "shared_applications": math.ceil(cfg.num_layers / cfg.attn_every)
              if cfg.family == "hybrid" else 0,
              "dtype": "bfloat16", "quant": "int8",
              "int8_weight_bytes": sum(t.q.numel() for t in _quant_leaves(eng.params)),
              "quantize_at_init_s": r6(init_s)}
    what = f"serve_ssm {arch}"
    with CallLog() as log:
        pool, tokens_q = generate_and_slots(eng, prompts, rng, what, report)
        # the replayed decode tick: unprofiled, profiled, and what it must move
        replayed = []
        for _ in range(TIMED_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.masked_decode_step(pool)
            replayed.append((time.perf_counter() - t0) * 1e3)
        tick = profile_call(lambda: eng.masked_decode_step(pool))
        moved = ssm_tick_bytes(eng, pool)
        report["decode_tick"] = {
            "unprofiled_ms_median": r6(statistics.median(replayed)),
            "unprofiled_ms": [r6(t) for t in replayed], "profile": tick, "bytes": moved,
            "busy_over_bound": r6(tick["device_busy_ms"] / moved["bound_ms"]),
            "int8_matmul_share_of_busy": r6(tick["int8_matmul_device_ms"]
                                            / tick["device_busy_ms"])}
        cpool = chunked_group(eng, rng, what, report)
        plain, vpool, sprompts, chain, drafts = verify_steps(eng, rng, what, report)
        report["poison_resume"] = poison_resume(eng, plain, sprompts, chain, what)
        report["graph_vs_eager"] = ticks_vs_eager(eng, plain, vpool, drafts, what)
        report["long_prompt"] = long_prompt(eng, dev)
        report["verify_snapshot_bytes"] = snapshot_bytes(cfg, vpool.max_batch, SPEC_K + 1)
        graphs = [g for p in (pool, cpool, plain, vpool) for g in eng.step_graphs(p).values()]
    log.check(what)
    replays = graph_launches(graphs, cfg, what)
    agreement = twin_agreement(full, prompts, tokens_q, what)
    del full
    blocks = [("mamba", "blocks", transformer.ssm_block_prefill, True, 3)]
    if "shared" in eng.params:
        blocks.append(("shared", "shared", shared_block_prefill, False, 9))
    report["block_card_vs_cpu"] = {}
    for name, stack, body, layered, want in blocks:
        with runtime.launches_recorded() as block_launches:  # a module check, not the path
            r = check_block_card_vs_cpu(eng, dev, stack, body, layered)
        if block_launches.get("int8_matmul") != want:
            fail(f"serve_ssm {arch}: the {name} block on the card launched {block_launches}, "
                 f"{want} int8_matmul expected")
        report["block_card_vs_cpu"][name] = dict(r, int8_matmul_launches=want)
    decode_ms = [c["ms"] for c in log.calls if c["kind"] == "decode_step"]
    report.update({
        "int8_matmul_per_call": k5_per_call(cfg, "decode_step"),
        "calls": len(log.calls), "graphs": len(graphs),
        "replays": sum(g.replays for g in graphs),
        "eager_decode_ms_median": r6(statistics.median(decode_ms)),
        "greedy_agreement_vs_bf16": r6(agreement), "agreement_floor": AGREEMENT_FLOOR,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "seconds": r6(time.perf_counter() - t_start)})
    return {"int8_matmul": sum(c["per_call"] for c in log.calls) + replays, "report": report}


def drive_serve_ssm(dev) -> dict:
    """mamba2-780m, then (its engines freed) zamba2-7b, each at full width and
    full depth, then the reduced configs of both in f32 with int8 weights,
    token for token: chunked == blocking and speculative == plain."""
    report, expect = {"strict_identity": {}}, 0
    for arch in SSM_ARCHS:
        out = serve_ssm_config(dev, arch)
        report[arch] = out["report"]
        expect += out["int8_matmul"]
        torch.cuda.empty_cache()
    for arch in SSM_ARCHS:
        report["strict_identity"][arch], launched = strict_identity_logged(
            dev, arch, f"serve_ssm strict identity {arch}")
        expect += launched
    return {"expect": {"int8_matmul": expect}, "report": report}


# ---------------------------------------------------------------------------
# serve_audio and serve_vlm: the enc-dec audio family (whisper-tiny) and the
# vision-language model (internvl2-76b) through the same engine
# ---------------------------------------------------------------------------
WHISPER = "whisper-tiny"            # full width, full depth: 4 encoder + 4 decoder layers
WHISPER_K5_M, WHISPER_K5_KN = (4, 1500, 6000), [(384, 384), (384, 1536), (1536, 384)]
VLM_K5_M = (4, 20, 96, 320, 1280)
VLM_K5_KN = [(8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192)]
VLM = "internvl2-76b"
VLM_LAYERS = 8                      # the only cut: 80 → 8 layers (int8 + the bf16 twin fit)
VLM_SC = {"max_batch": 4, "max_len": 384, "spec_slack": 4}  # 256 image rows + text + budget
VLM_CHUNK = 48                      # chunks 240-288 of a 320-position prompt straddle 256
FRONTEND_PROMPT = 64                # the text tokens of the random-input prefill


def encoder_block(p, x, cfg):
    """whisper's encoder block over ``x``, with its attention's (k, v), for
    :func:`check_block_card_vs_cpu` (``transformer.enc_block_apply``, the
    attention's rows kept)."""
    a, kv = transformer.gqa_full(p["attn"], transformer.apply_norm(cfg, p["ln1"], x), cfg,
                                 causal=False, rope=False)
    return transformer._ffn(p, x + a, cfg)[0], kv


def decoder_block():
    """whisper's decoder prefill body over seeded random frames (numpy, std
    1, 1500 x 384) as the encoder output, on whichever device its input
    lies: its cache rows are (k, v, cross_k, cross_v)."""
    cfg = get_config(WHISPER)
    enc = np.random.default_rng(81).standard_normal((1, cfg.encoder_seq, cfg.d_model))

    def decoder_block(p, x, cfg):
        e = torch.as_tensor(enc, dtype=x.dtype, device=x.device)
        return transformer.dec_block_prefill(p, x, e, cfg)

    return decoder_block


def attention_tick_bytes(eng, pool) -> dict:
    """Bytes one decode tick of the pool must move: the decoder's weights
    once (the stack, the final norm, the unembedding: whisper's tied table,
    internvl2's own), the self-attention K/V read over the pool's capacity,
    and whisper's cross K/V read over its frames."""
    p = eng.params
    unembed = p["embed"].get("unembed", p["embed"]["tokens"])
    weights = {"decoder_layers": tree_bytes(p["blocks"]),
               "final_norm": tree_bytes(p["final_norm"]), "unembedding": tree_bytes(unembed)}
    cache = {"kv_read": tree_bytes([pool.cache["k"], pool.cache["v"]]),
             "cross_kv_read": tree_bytes([pool.cache[k] for k in ("cross_k", "cross_v")
                                          if k in pool.cache])}
    total = sum(weights.values()) + sum(cache.values())
    return {"weights": weights, "cache": cache, "total": total,
            "cross_kv_a_slot": cache["cross_kv_read"] // pool.max_batch,
            "bound_ms": r6(total / PEAK_BYTES_PER_S * 1e3), "bound_by": "bytes"}


def frontend_prefill(eng, dev) -> dict:
    """One prompt through ``prefill`` with seeded random front-end inputs
    (numpy): whisper's 1500 frames at std 1, internvl2's 256 patch
    embeddings at the token embedding's scale (0.02) ahead of
    ``FRONTEND_PROMPT`` text tokens; and the same prompt as its chunked
    composition: whisper's cross K/V from ``encoder_cross_cache``, then
    chunks of ``CHUNK_TOKENS``; internvl2's patches padded to the prompt's
    length, chunks of ``VLM_CHUNK``.  All through the engine's model calls
    (logged and counted).  The last logits and every layer's K/V held to
    each other (``LONG_TOL``), whisper's cross K/V the same bits."""
    cfg = eng.cfg
    rng = np.random.default_rng(82)
    lead = image_rows(eng)
    n = lead + FRONTEND_PROMPT
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)
    if cfg.family == "audio":
        fe = rng.standard_normal((1, cfg.encoder_seq, cfg.d_model))
        chunk = CHUNK_TOKENS
    else:
        fe = rng.standard_normal((1, cfg.frontend_seq, cfg.d_model)) * 0.02
        chunk = VLM_CHUNK
    fe = torch.as_tensor(fe, dtype=cfg.dtype, device=dev)
    with torch.inference_mode():
        logits, cache = engine_mod.prefill(eng.params, toks, cfg, frontend_embeds=fe)
        chunked = init_params(cache_defs(cfg, batch=1, max_len=n), torch.Generator(), dev)
        padded = None
        if cfg.family == "audio":
            ck, cv = engine_mod.encoder_cross_cache(eng.params, cfg, fe)
            chunked["cross_k"].copy_(ck)
            chunked["cross_v"].copy_(cv)
        else:
            padded = torch.zeros((1, n, cfg.d_model), dtype=cfg.dtype, device=dev)
            padded[:, :lead] = fe
        for pos in range(0, n, chunk):
            clog, chunked = engine_mod.prefill_chunk(eng.params, chunked, toks[:, pos:pos + chunk],
                                                     pos, cfg, frontend_embeds=padded)
    vocab, what = cfg.vocab_size, f"{cfg.name} random-input prefill"
    out = {"tokens": n, "front_end": list(fe.shape), "chunk_tokens": chunk,
           "tolerance": f"max {LONG_TOL}, mean {LONG_MEAN_TOL} x max|blocking|",
           "last_logits": held(clog[:, :vocab], logits[:, :vocab], f"{what} logits", LONG_TOL,
                               LONG_MEAN_TOL),
           "argmax_blocking": int(logits[0, :vocab].argmax()),
           "argmax_chunked": int(clog[0, :vocab].argmax())}
    for key in ("k", "v"):
        out[key] = held(chunked[key], cache[key], f"{what} cache {key!r}", LONG_TOL,
                        LONG_MEAN_TOL)
    for key in ("cross_k", "cross_v"):
        if key in cache:
            if not same_bits(chunked[key], cache[key]):
                fail(f"{what}: encoder_cross_cache's {key} is not prefill's, bit for bit")
            out[key] = "bitwise equal"
    return out


def serve_frontend_config(dev, arch: str, layers: int | None, sc: dict, chunk_tokens: int,
                          blocks) -> dict:
    """One config with a front-end through the int8 engine, as
    :func:`serve_ssm_config`: ``generate``, the slot path (the replayed
    decode tick timed, profiled and set beside :func:`attention_tick_bytes`),
    a chunked prefill while two slots decode (in chunks of
    ``chunk_tokens``), verify ticks teacher-forced from the plain chain,
    poison → quarantine → resume (whisper: the resumed slot's cross K/V
    those of a fresh prefill of its context, bit for bit), the replayed
    ticks against the eager ones, :func:`frontend_prefill`; greedy
    agreement with the bf16 twin; ``blocks`` (name, stack, prefill body,
    int8_matmul launches) on the card against the CPU."""
    t_start = time.perf_counter()
    cfg_f = get_config(arch)
    if layers is not None:
        cfg_f = dataclasses.replace(cfg_f, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    eng, full, init_s = twin_engines(dev, cfg_f, sc)
    cfg, vocab = eng.cfg, cfg_f.vocab_size
    rng = np.random.default_rng(80)
    prompts = rng.integers(0, vocab, (GEN_PROMPTS, image_rows(eng) + GEN_LEN)).astype(np.int32)
    report = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
              "of_layers": get_config(arch).num_layers, "encoder_layers": cfg.encoder_layers,
              "image_rows": image_rows(eng), "dtype": "bfloat16", "quant": "int8",
              "serve_config": sc,
              "int8_weight_bytes": sum(t.q.numel() for t in _quant_leaves(eng.params)),
              "quantize_at_init_s": r6(init_s)}
    what = f"serve {arch}"
    with CallLog() as log:
        pool, tokens_q = generate_and_slots(eng, prompts, rng, what, report)
        replayed = []
        for _ in range(TIMED_TICKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.masked_decode_step(pool)
            replayed.append((time.perf_counter() - t0) * 1e3)
        tick = profile_call(lambda: eng.masked_decode_step(pool))
        moved = attention_tick_bytes(eng, pool)
        report["decode_tick"] = {
            "unprofiled_ms_median": r6(statistics.median(replayed)),
            "unprofiled_ms": [r6(t) for t in replayed], "profile": tick, "bytes": moved,
            "busy_over_bound": r6(tick["device_busy_ms"] / moved["bound_ms"]),
            "int8_matmul_share_of_busy": r6(tick["int8_matmul_device_ms"]
                                            / tick["device_busy_ms"])}
        cpool = chunked_group(eng, rng, what, report, chunk_tokens)
        plain, vpool, sprompts, chain, drafts = verify_steps(eng, rng, what, report)
        report["poison_resume"] = poison_resume(eng, plain, sprompts, chain, what)
        if cfg.family == "audio":
            context = np.concatenate([sprompts[1], np.asarray(chain[1][:-1], np.int32)])
            with torch.inference_mode():  # a fresh prefill of the context, outside the count
                with runtime.launches_recorded():
                    _, fresh = model_mod.prefill(
                        eng.params, torch.as_tensor(context[None].astype(np.int64), device=dev),
                        cfg, frontend_embeds=eng._frontend_stub(1))
            for key in ("cross_k", "cross_v"):
                if not same_bits(plain.cache[key][:, 1], fresh[key][:, 0]):
                    fail(f"{what}: the resumed slot's {key} is not a fresh prefill's")
            report["poison_resume"]["resumed_cross_kv"] = "bitwise equal to a fresh prefill's"
        report["graph_vs_eager"] = ticks_vs_eager(eng, plain, vpool, drafts, what)
        report["frontend_prefill"] = frontend_prefill(eng, dev)
        graphs = [g for p in (pool, cpool, plain, vpool) for g in eng.step_graphs(p).values()]
    log.check(what)
    replays = graph_launches(graphs, cfg, what)
    tokens_f = full.generate(prompts, GEN_NEW)
    agreement = float((tokens_q == tokens_f).mean())
    per_step = step_agreement(eng, full, prompts, tokens_f, dev)
    # the vision-language model's chains part at near ties within a few
    # tokens (0.03-0.31 over six prompt draws, ``agreement_check.py``) while its
    # per-step agreement reads 0.59-0.75: there the floor holds the per-step
    # agreement, which the chain agreement lower-bounds; whisper the chain's
    gated = per_step["agreement"] if cfg.family == "vlm" else agreement
    if gated < AGREEMENT_FLOOR:
        fail(f"{what}: agreement {gated:.3f} with the bf16 engine (chain {agreement:.3f}, "
             f"per step {per_step['agreement']}), under the floor {AGREEMENT_FLOOR}")
    del full
    report["block_card_vs_cpu"] = {}
    for name, stack, body, want in blocks:
        with runtime.launches_recorded() as block_launches:  # a module check, not the path
            r = check_block_card_vs_cpu(eng, dev, stack, body)
        if block_launches.get("int8_matmul") != want:
            fail(f"{what}: the {name} block on the card launched {block_launches}, "
                 f"{want} int8_matmul expected")
        report["block_card_vs_cpu"][name] = dict(r, int8_matmul_launches=want)
    decode_ms = [c["ms"] for c in log.calls if c["kind"] == "decode_step"]
    report.update({
        "int8_matmul_per_call": {k: k5_per_call(cfg, k) for k in (
            "prefill", "decode_step", "prefill_chunk", "decode_verify",
            *(("encoder_cross_cache",) if cfg.family == "audio" else ()))},
        "calls": len(log.calls), "graphs": len(graphs),
        "replays": sum(g.replays for g in graphs),
        "eager_decode_ms_median": r6(statistics.median(decode_ms)),
        "greedy_agreement_vs_bf16": r6(agreement), "step_agreement_vs_bf16": per_step,
        "agreement_floor": AGREEMENT_FLOOR,
        "floor_holds": "per-step agreement" if cfg.family == "vlm" else "chain agreement",
        "distinct_tokens": {"generate": len(set(tokens_q.ravel().tolist())),
                            "of": int(tokens_q.size)},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "seconds": r6(time.perf_counter() - t_start)})
    return {"int8_matmul": sum(c["per_call"] for c in log.calls) + replays, "report": report}


def step_agreement(eng, full, prompts, chain_f, dev) -> dict:
    """Per-step agreement with the bf16 twin: the int8 model's argmax at each
    of the twin's greedy positions, given the twin's own chain as context
    (teacher-forced, one forward pass of each; launches recorded apart), and
    the largest |int8 - bf16| of those logits over the largest |logit|.
    The greedy-chain agreement is a lower bound of it (``docs/kernels.md``):
    two chains part for good at their first flip."""
    b, n = chain_f.shape
    ctx = np.concatenate([prompts, chain_f[:, :-1]], axis=1).astype(np.int64)
    toks = torch.as_tensor(ctx, device=dev)
    vocab, last = eng.cfg.vocab_size, prompts.shape[1] - 1
    logits = []
    with torch.inference_mode(), runtime.launches_recorded():
        for e in (eng, full):
            hidden, _ = model_mod.forward(e.params, toks, e.cfg, e._frontend_stub(b))
            logits.append(unembed_apply(e.params["embed"], hidden[:, last:], e.cfg)[
                ..., :vocab].float())
    lq, lf = logits
    scale = lf.abs().amax(dim=-1)
    return {"positions": b * n,
            "agreement": r6(float((lq.argmax(-1).cpu().numpy() == chain_f).mean())),
            "logits_max_abs_diff_rel": r6(float(((lq - lf).abs().amax(-1) / scale).max()))}


def drive_serve_audio(dev) -> dict:
    """whisper-tiny at full width and full depth (4 + 4 layers, no cut),
    then its reduced config in f32 with int8 weights, token for token:
    chunked == blocking and speculative == plain."""
    blocks = [("encoder", "enc_blocks", encoder_block, 6),
              ("decoder", "blocks", decoder_block(), 10)]
    out = serve_frontend_config(dev, WHISPER, None, ENGINE_SC, CHUNK_TOKENS, blocks)
    torch.cuda.empty_cache()
    identity, launched = strict_identity_logged(dev, WHISPER, "serve_audio strict identity")
    return {"expect": {"int8_matmul": out["int8_matmul"] + launched},
            "report": {WHISPER: out["report"], "strict_identity": identity}}


def drive_serve_vlm(dev) -> dict:
    """internvl2-76b at full width, cut to ``VLM_LAYERS`` layers, its prompts
    256 image positions (the engine's stub) and then text; then its reduced
    config in f32 with int8 weights, token for token."""
    blocks = [("decoder", "blocks", transformer.dense_block_prefill, 7)]
    out = serve_frontend_config(dev, VLM, VLM_LAYERS, VLM_SC, VLM_CHUNK, blocks)
    torch.cuda.empty_cache()
    identity, launched = strict_identity_logged(dev, VLM, "serve_vlm strict identity")
    return {"expect": {"int8_matmul": out["int8_matmul"] + launched},
            "report": {VLM: out["report"], "strict_identity": identity}}


# ---------------------------------------------------------------------------
# duty_cycle: the paper's RQ2 strategies applied to the served int8 engine
# ---------------------------------------------------------------------------
DUTY_LATENCY = {"batch": 4, "prompt_len": 16, "new_tokens": 8}  # measure_latency's defaults
DUTY_SAMPLES = 3                    # measure_latency calls; the profiles take their median
DUTY_GAPS = 40                      # each regular trace: tests/test_serving.py's regimes,
DUTY_SCALES = {"short": 0.05, "long": 20.0}  # gaps of 0.05 and 20 break-even τ
DUTY_BURSTY = 400                   # the seeded bursty trace
DUTY_EXECUTE = {"short": 40, "long": 40, "bursty": 200}  # execute_every: 1, 1, 2 runs a strategy
ADAPTIVE_FLOOR = 0.45               # adaptive's items/J against the best (tests/test_serving.py)
STREAM_GAPS = 1200                  # the streaming policy's run (tests/test_scheduler.py)
STREAM_KW = {"window": 400, "refit_every": 150, "refit_steps": 150}
STREAM_FLOOR = 0.9                  # online items/J against offline learn_tau's
IDLE_SETTLE_S, POWER_LOOP_S = 2.0, 2.5
DRAFT_LENS, DRAFT_BUDGET, DRAFT_PERIOD = (16, 24, 32), 24, 4
# A drafted token that teacher-forced plain decode does not pick must be a
# near tie of plain decode's logits: margin at most DRAFT_TIE of the largest
# |logit|.  Read on an H100 80GB HBM3 at 700 W: 6 flips in 92 positions at
# margins 0.35-1.43% (1 to 4 bf16 units of the largest logit; verify's
# logits differ from decode's by up to 1.7% of it, VERIFY_LOGIT_DIFF's
# readings), while plain decode's own top two sit 1.28 / 3.72 / 7.11% apart
# (quartiles over those positions; random weights give flat logits): a
# drafting, acceptance or rollback fault that emits any token but plain
# decode's runner-up shows a margin over that gap.
DRAFT_TIE = 0.02


def generate_calls(new_tokens: int) -> int:
    """Model calls of one ``generate``: the prefill and one decode step a
    new token."""
    return 1 + new_tokens


def measured_chip(eng, fixed_s: float) -> tuple[dict, object, int]:
    """The three ``AccelProfile`` constants of this engine on the card:
    ``power.draw`` idle, ``power.draw`` during a loop of the ``generate``
    that ``measure_latency`` times, and one pinned host-to-device copy of
    the engine's weight tensors (each copied back into a tensor of its own
    and held bit for bit).  ``fixed_s`` is the ``energy`` phase's library
    load and first launch.  Returns the report, an ``H100Chip`` holding the
    measured constants, and the ``generate`` calls of the loop."""
    chip = DEFAULT_CHIP
    idle = idle_power(IDLE_SETTLE_S)
    prompts = np.zeros((DUTY_LATENCY["batch"], DUTY_LATENCY["prompt_len"]), np.int32)
    busy, loops, loop_s = power_while(
        lambda: eng.generate(prompts, DUTY_LATENCY["new_tokens"]), POWER_LOOP_S)
    if not busy:
        fail("duty_cycle: no power.draw sample during the generate loop")

    tensors = tree_tensors(eng.params)
    nbytes = tree_bytes(eng.params)
    host = [x.cpu().pin_memory() for x in tensors]
    card = [torch.empty_like(x) for x in tensors]

    def reload():
        for c, h in zip(card, host):
            c.copy_(h, non_blocking=True)

    copy_ms = time_ms(reload, reps=1, rounds=5)
    if not all(same_bits(c, x) for c, x in zip(card, tensors)):
        fail("duty_cycle: the reloaded weights differ from the engine's")
    del host, card
    idle_w, active_w = statistics.median(idle), statistics.median(busy)
    copy_s = copy_ms * 1e-3
    default_bytes = 2.0 * eng.cfg.param_count()
    report = {
        "gpu": smi_query("name") + ", " + smi_query("power.limit") + " W",
        "idle_w": r6(idle_w), "idle_samples": idle, "chip_p_idle_w": chip.p_idle_w,
        "active_w": r6(active_w), "active_samples": busy, "chip_p_peak_w": chip.p_peak_w,
        "generate_loop": {"calls": loops, "seconds": r6(loop_s),
                          "call_s": r6(loop_s / loops)},
        "reload": {"weight_tensors": len(tensors), "weight_bytes": nbytes,
                   "pinned_copy_ms": r6(copy_ms), "bytes_per_s": r6(nbytes / copy_s),
                   "library_load_and_first_launch_s": r6(fixed_s),
                   "measured_s": r6(copy_s + fixed_s),
                   "chip_reload_time_s_at_measured_bytes": r6(chip.reload_time(nbytes)),
                   "default_weight_bytes": default_bytes,
                   "gpu_reload_costs_s": r6(engine_mod.gpu_reload_costs(eng.cfg)[0])},
    }
    measured = dataclasses.replace(chip, p_idle_w=idle_w, p_peak_w=active_w,
                                   reload_bw=nbytes / copy_s, reload_fixed_s=fixed_s)
    return report, measured, loops


def stats_dict(stats) -> dict:
    return {**{k: r6(v) if isinstance(v, float) else v
               for k, v in dataclasses.asdict(stats).items()},
            "items_per_joule": r6(stats.items_per_joule)}


def strategy_runs(srv, t_inf: float) -> tuple[dict, int]:
    """``compare_strategies`` under ``srv``'s profile on the regular traces
    at 0.05 and 20 break-even τ and on a seeded bursty trace, the engine
    really run every ``DUTY_EXECUTE`` batches; the reference's orderings
    held.  Returns the report and the ``generate`` calls made."""
    prof = srv.profile(t_inf)
    tau = workload_mod.break_even_tau(prof)
    traces = {k: workload_mod.regular_trace(s * tau + t_inf, t_inf, DUTY_GAPS)
              for k, s in DUTY_SCALES.items()}
    traces["bursty"] = workload_mod.bursty_trace(prof, DUTY_BURSTY, seed=21)
    report, runs = {"profile": {k: r6(v) for k, v in dataclasses.asdict(prof).items()},
                    "break_even_tau_s": r6(tau)}, 0
    for name, gaps in traces.items():
        res = srv.compare_strategies(gaps, t_inf=t_inf, execute_every=DUTY_EXECUTE[name],
                                     **DUTY_LATENCY)
        runs += len(res) * -(-gaps.size // DUTY_EXECUTE[name])
        ipj = {k: v.items_per_joule for k, v in res.items()}
        best = max(ipj.values())
        report[name] = {"gaps": gaps.size, "mean_gap_s": r6(float(gaps.mean())),
                        "best": max(ipj, key=ipj.get),
                        "stats": {k: stats_dict(v) for k, v in res.items()}}
        if name == "short" and ipj["on_off"] > ipj["idle_waiting"]:
            fail(f"duty_cycle: on-off beats idle-waiting at short gaps: {report[name]}")
        if name == "long" and ipj["idle_waiting"] > ipj["on_off"]:
            fail(f"duty_cycle: idle-waiting beats on-off at long gaps: {report[name]}")
        if ipj["adaptive"] < ADAPTIVE_FLOOR * best:
            fail(f"duty_cycle: adaptive under {ADAPTIVE_FLOOR} of the best on {name}: "
                 f"{report[name]}")
    return report, runs


def streaming_tau(prof, dev) -> dict:
    """A ``StreamingTauPolicy`` refitting τ on the card, fed a seeded bursty
    trace; its items/J against offline ``learn_tau`` on the same trace."""
    gaps = workload_mod.bursty_trace(prof, STREAM_GAPS, seed=22)
    pol = policy_mod.StreamingTauPolicy(prof, device=dev, **STREAM_KW)
    if pol.device.type != "cuda":
        fail(f"duty_cycle: the streaming policy refits on {pol.device}")
    t0 = time.perf_counter()
    gap_e = sum(pol.on_gap(float(g)).energy_j for g in gaps)
    online_s = time.perf_counter() - t0
    online = gaps.size / (prof.e_cfg_j + prof.p_active_w * prof.t_inf_s * gaps.size + gap_e)
    tau_off = workload_mod.learn_tau(gaps, prof, device=dev)
    offline = workload_mod.simulate(gaps, "adaptive", prof, tau=tau_off).items_per_joule
    break_even = workload_mod.simulate(gaps, "adaptive", prof,
                                       tau=workload_mod.break_even_tau(prof)).items_per_joule
    report = {"gaps": gaps.size, **STREAM_KW, "refits": pol.refits, "tau_s": r6(pol.tau),
              "tau_offline_s": r6(tau_off),
              "break_even_tau_s": r6(workload_mod.break_even_tau(prof)),
              "online_items_per_joule": r6(online), "offline_items_per_joule": r6(offline),
              "break_even_items_per_joule": r6(break_even),
              "online_over_offline": r6(online / offline), "floor": STREAM_FLOOR,
              "seconds": r6(online_s)}
    if pol.refits != STREAM_GAPS // STREAM_KW["refit_every"] or online < STREAM_FLOOR * offline:
        fail(f"duty_cycle: streaming policy {json.dumps(report)}")
    return report


def drafted_chains(eng, what: str) -> dict:
    """``NgramDrafter`` with a ``SpecThrottle`` over a pool of 4 periodic
    prompts (``load.poisson_stream``'s ``prompt_period``): each tick the
    drafter proposes ``SPEC_K`` tokens a slot, the tick's K is the largest
    window the throttle grants (a plain decode tick when it grants none),
    and ``masked_speculative_step`` verifies them on the replayed verify
    tick.  Each emitted chain is then held against plain decode of the same
    engine teacher-forced on it: a pool prefilled alike decodes the chain a
    token a tick, and at every position its own pick must be the chain's
    token or a near tie of its logits (margin at most ``DRAFT_TIE`` of the
    largest |logit|), the chain as long as the request's budget.  Plain
    decode runs K7 and verify the chunk's attention: two orders of the same
    f32 sums, each rounded once to bf16."""
    reqs = load_mod.poisson_stream(4, rate_hz=100.0, seed=23, vocab_size=eng.cfg.vocab_size,
                                   prompt_lens=DRAFT_LENS, new_tokens=(DRAFT_BUDGET,) * 2,
                                   prompt_period=DRAFT_PERIOD)
    plain, vpool = eng.make_pool(), eng.make_pool()
    drafter, throttle = draft_mod.NgramDrafter(SPEC_K), draft_mod.SpecThrottle(SPEC_K)
    got = {}
    for s, r in enumerate(reqs):
        first = eng.prefill_into_slot(vpool, s, r.prompt, rid=r.rid, budget=r.new_tokens)
        got[r.rid] = [first]
        drafter.begin(r.rid, np.append(r.prompt, first))
        throttle.begin(r.rid)
    ticks = {"verify": 0, "decode": 0}
    fielded = accepted = 0
    while vpool.decoding_count:
        live = vpool.decoding_slots()
        rids = {s: vpool.slots[s].rid for s in live}
        k = max(throttle.window(rids[s]) for s in live)
        if k:
            drafts = np.zeros((vpool.max_batch, k), np.int32)
            for s in live:
                drafts[s] = drafter.propose(rids[s])[:k]
            toks, acc, fin = eng.masked_speculative_step(vpool, drafts)
        else:
            nxt, fin = eng.masked_decode_step(vpool)
            toks, acc = nxt[:, None], np.zeros(vpool.max_batch, np.int32)
        ticks["verify" if k else "decode"] += 1
        if not fin[live].all():
            fail(f"{what}: a drafting slot read non-finite")
        for s in live:
            rid, a, info = rids[s], int(acc[s]), vpool.slots[s]
            emit = [int(x) for x in toks[s, :a + 1][:info.budget - info.emitted]]
            got[rid] += emit
            drafter.observe(rid, emit)
            throttle.observe(rid, a, k)
            fielded, accepted = fielded + k, accepted + a
            if info.emitted + len(emit) >= info.budget:
                vpool.retire(s)
                drafter.forget(rid)
                throttle.forget(rid)
            else:
                vpool.advance(s, a + 1, int(toks[s, a]))
    # plain decode, teacher-forced on the drafted chains
    for s, r in enumerate(reqs):
        first = eng.prefill_into_slot(plain, s, r.prompt, rid=r.rid, budget=r.new_tokens)
        if first != got[r.rid][0]:
            fail(f"{what}: the same prefill gave another first token")
    held, flips, top2 = {rid: 1 for rid in got}, [], []
    while plain.decoding_count:
        live = plain.decoding_slots()
        nxt, fin = eng.masked_decode_step(plain)
        if not fin[live].all():
            fail(f"{what}: a plain decoding slot read non-finite")
        logits = eng.step_graphs(plain)[("decode", 0)].outputs["logits"]
        for s in live:
            rid = plain.slots[s].rid
            chain, j = got[rid], held[rid]
            if j >= len(chain):
                fail(f"{what}: request {rid} emitted {len(chain)} tokens, plain decode more")
            ld = logits[s, :eng.cfg.vocab_size].float().cpu()
            best = ld.topk(2).values
            top2.append(float(best[0] - best[1]) / float(ld.abs().max()))
            if int(nxt[s]) != chain[j]:
                flips.append({"rid": rid, "j": j, "plain": int(nxt[s]), "drafted": chain[j],
                              "margin_rel": r6(float(ld[int(nxt[s])] - ld[chain[j]])
                                               / float(ld.abs().max()))})
            held[rid] = j + 1
            plain.advance(s, 1, chain[j])
            if plain.slots[s].emitted >= plain.slots[s].budget:
                plain.retire(s)
    if any(len(got[rid]) != n for rid, n in held.items()):
        fail(f"{what}: drafted chains of {[len(got[rid]) for rid in held]} tokens, plain decode "
             f"{list(held.values())}")
    if any(f["margin_rel"] > DRAFT_TIE for f in flips):
        fail(f"{what}: a drafted token is no near tie of teacher-forced plain decode (limit "
             f"{DRAFT_TIE}): {json.dumps(flips)}")
    graphs = [g for p in (plain, vpool) for g in eng.step_graphs(p).values()]
    return {"requests": len(reqs), "prompt_lens": [int(r.prompt.size) for r in reqs],
            "prompt_period": DRAFT_PERIOD, "budget": DRAFT_BUDGET, "k_max": SPEC_K,
            "ticks": ticks, "graphs": sorted(f"{kind}{k}" for p in (plain, vpool)
                                              for kind, k in eng.step_graphs(p)),
            "drafts_fielded": fielded, "drafts_accepted": accepted,
            "acceptance_rate": r6(accepted / fielded) if fielded else None,
            "tokens_per_request": DRAFT_BUDGET,
            "positions_compared": sum(held.values()) - len(held),
            "chains_equal_plain_decode": len(held) - len({f["rid"] for f in flips}),
            "near_tie_flips": flips, "flip_margin_limit": DRAFT_TIE,
            "top2_margin_rel_quartiles": [r6(x) for x in statistics.quantiles(top2, n=4)],
            "top2_margin_rel_min": r6(min(top2)),
            "distinct_tokens": len({t for c in got.values() for t in c}),
            "replayed_int8_matmul": sum(g.replays * g.launches.get("int8_matmul", 0)
                                        for g in graphs)}


def drive_duty_cycle(dev, base, energy: dict) -> dict:
    """The workload-aware server (``WorkloadAwareServer``) on the int8
    engine of ``serve_dense`` (granite-3-8b, 8 layers, ``standard_fan_in``,
    the same weights and ``ServeConfig(max_batch=4, max_len=128)``): the
    measured latency of the eager ``generate``, the three profile constants
    measured on the card (``measured_chip``), the four strategies under the
    chip's profile and the measured one (``strategy_runs``), the streaming
    policy on the card, and the drafter verified on the replayed verify
    tick (an engine of the same weights with ``spec_slack`` = 4)."""
    eng = engine_mod.InferenceEngine(base.cfg, params=base.params, device=dev,
                                     sc=engine_mod.ServeConfig(max_batch=4, max_len=128))
    srv = engine_mod.WorkloadAwareServer(eng)
    samples = [srv.measure_latency(**DUTY_LATENCY) for _ in range(DUTY_SAMPLES)]
    t_inf = statistics.median(samples)
    measured, chip, loops = measured_chip(eng,
                                          energy["reload"]["library_load_and_first_launch_s"])
    msrv = engine_mod.WorkloadAwareServer(eng, chip=chip,
                                          weight_bytes=measured["reload"]["weight_bytes"])
    chip_runs, chip_n = strategy_runs(srv, t_inf)
    measured_runs, measured_n = strategy_runs(msrv, t_inf)
    stream = streaming_tau(msrv.profile(t_inf), dev)
    spec = engine_mod.InferenceEngine(base.cfg, params=base.params, device=dev,
                                      sc=engine_mod.ServeConfig(**ENGINE_SC))
    with CallLog() as log:
        drafting = drafted_chains(spec, "duty_cycle drafter")
    log.check("duty_cycle drafter")
    per_call = k5_per_call(eng.cfg, "decode_step")
    new = DUTY_LATENCY["new_tokens"]
    generate_k5 = per_call * (DUTY_SAMPLES * (generate_calls(2) + generate_calls(new))
                              + (loops + chip_n + measured_n) * generate_calls(new))
    draft_k5 = sum(c["per_call"] for c in log.calls) + drafting["replayed_int8_matmul"]
    report = {
        "arch": GRANITE, "layers": eng.cfg.num_layers, "quant": "int8",
        "serve_config": {"max_batch": 4, "max_len": 128},
        "t_inf_s": r6(t_inf), "t_inf_samples_s": [r6(s) for s in samples],
        "t_inf_is": "WorkloadAwareServer.measure_latency: one eager generate of 4 x 16 zero "
                    "prompts, 8 new tokens, after a warm-up",
        "profile_constants": measured,
        "strategies": {"chip": chip_runs, "measured": measured_runs},
        "streaming_policy": stream, "drafter": drafting,
        "int8_matmul": {"generate_runs": DUTY_SAMPLES * 2 + loops + chip_n + measured_n,
                        "per_call": per_call, "generate": generate_k5, "drafter": draft_k5},
    }
    return {"expect": {"int8_matmul": generate_k5 + draft_k5}, "report": report}


# ---------------------------------------------------------------------------
# serve_scheduler: the continuous-batching scheduler at full width
# ---------------------------------------------------------------------------
SCHED_REQUESTS = 16                 # a seeded Poisson stream of 16 requests
SCHED_PROMPTS = (16, 32, 48)        # prompt lengths drawn from these buckets
SCHED_NEW = (8, 24)                 # new tokens a request, uniform
SCHED_LOAD = 8.0                    # arrivals a mean service time: the pool of 4 fills and queues
SCHED_SEED = 23
SCHED_PERIOD = 4                    # period-4 prompts, the launcher's speculative default
SCHED_CHUNK = 16
SCHED_FAULT_SEED = 5                # "light" profile: quarantines on this stream (see PERF.md)
SCHED_PRESSURE_PAGES = 11           # 10 allocatable: half of 4 slots x 5 pages (48 + 24 rows)
SCHED_TIER_MIX = 0.5
SCHED_CAP_W = 300.0                 # sustained cap, between idle (126 W) and the 700 W limit
SCHED_BUDGET_WINDOW_S = 0.25
SCHED_BUDGET_IDLE_FLOORS = 2.0      # energy budget: twice the idle floor of a window
SCHED_REDUCED_SC = {"max_batch": 3, "max_len": 48, "spec_slack": 4}
SCHED_FIXED = {"step_s": 0.004, "prefill_base_s": 0.001, "prefill_per_tok_s": 0.001,
               "verify_per_tok_s": 0.0001}


class ModelCalls:
    """While entered, counts the engine's eager model calls (``prefill``,
    ``decode_step``, ``prefill_chunk``, ``decode_verify``,
    ``encoder_cross_cache``; none while a graph is being captured, which
    runs nothing) and every graph replay, with the int8_matmul launches each
    makes: ``k5_per_call`` of an int8 config for a call, the captured count
    for a replay.  Unlike ``CallLog`` it neither synchronises nor keeps
    outputs, so that the scheduler's wall time stays its own."""

    NAMES = ("prefill", "decode_step", "prefill_chunk", "decode_verify", "encoder_cross_cache")

    def __init__(self):
        self.calls = self.replays = self.int8_matmul = 0

    def __enter__(self):
        self.real = {name: getattr(engine_mod, name) for name in self.NAMES}
        self.real_replay = graphs_mod.StepGraph.replay
        for name, fn in self.real.items():
            setattr(engine_mod, name, self.wrap(name, fn))
        log = self

        def replay(g):
            out = log.real_replay(g)
            log.replays += 1
            log.int8_matmul += g.launches.get("int8_matmul", 0)
            return out

        graphs_mod.StepGraph.replay = replay
        return self

    def wrap(self, kind, fn):
        def call(*args, **kw):
            if not torch.cuda.is_current_stream_capturing():
                cfg = next(a for a in (*args, *kw.values()) if isinstance(a, ArchConfig))
                self.calls += 1
                self.int8_matmul += k5_per_call(cfg, kind) if cfg.quant == "int8" else 0
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(engine_mod, name, fn)
        graphs_mod.StepGraph.replay = self.real_replay


def replay_alone(eng, prompt, n: int, what: str) -> tuple[list, list]:
    """One request alone through ``eng``: its prefill's logits and first
    token, then ``n - 1`` replayed decode ticks (``decode_chain``) with theirs.
    Returns (tokens, the (V,) logits each token was taken from)."""
    vocab = eng.cfg.vocab_size
    toks = torch.as_tensor(np.asarray(prompt, np.int64), device=eng.device)[None]
    with torch.inference_mode():
        first = eng._prefill(eng.params, toks, eng._frontend_stub(1))[0][0, :vocab].float().cpu()
    pool = eng.make_pool()
    chain = {0: [eng.prefill_into_slot(pool, 0, prompt, rid=0, budget=n)]}
    logits = []
    decode_chain(eng, pool, chain, n - 1, what, logits)
    return chain[0], [first] + [lg[0] for lg in logits]


def near_tie_tokens(want: dict, got: dict, prompts: dict, eng, what: str,
                    exact: bool = False) -> dict:
    """``got``'s completed requests against ``want``'s (rid -> tokens): equal,
    or (unless ``exact``) equal up to a first differing token that is a near
    tie of the reference chain's own logits, read by replaying the request
    alone through ``eng`` (the engine ``want`` ran on): margin between the
    two tokens at most VERIFY_TIE of the largest |logit|, ``serve_paged``'s
    rule.  Nothing is compared past the first flip."""
    flips = []
    for rid, g in got.items():
        w = want[rid]
        if g == w:
            continue
        if exact or len(g) != len(w):
            fail(f"{what}: request {rid} gave {g}, the reference {w}")
        j = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
        toks, logits = replay_alone(eng, prompts[rid], j + 1, what)
        if toks != w[:j + 1]:
            fail(f"{what}: request {rid} alone gave {toks}, the reference run {w[:j + 1]}")
        scale = float(logits[j].abs().max())
        flip = {"rid": rid, "j": j, "want": w[j], "got": g[j],
                "margin_rel": r6(float(logits[j][w[j]] - logits[j][g[j]]) / scale)}
        flips.append(flip)
        if flip["margin_rel"] > VERIFY_TIE:
            fail(f"{what}: request {rid} flips at a margin over {VERIFY_TIE}: {json.dumps(flip)}")
    return {"compared": len(got), "equal": len(got) - len(flips), "flips": flips}


def completed(rep) -> dict:
    return {r.rid: list(r.tokens) for r in rep.records if not r.shed and not r.failed}


def run_summary(rep) -> dict:
    """A report's numbers under ``H100Chip``: items/J, virtual p50/p99 and
    the counters that are not zero."""
    out = {"items": rep.items, "items_per_joule": r6(rep.items_per_joule),
           "p50_ms": r6(rep.p50_s * 1e3), "p99_ms": r6(rep.p99_s * 1e3),
           "energy_j": r6(rep.energy_j), "time_s": r6(rep.time_s),
           "tokens": sum(len(r.tokens) for r in rep.records)}
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        if f.name not in out and isinstance(v, int) and not isinstance(v, bool) and v:
            out[f.name] = v
    return out


def timed_run(sched, reqs, what: str) -> tuple[object, dict]:
    """Two runs of one scheduler over ``reqs`` (its pool and graphs made by
    the first): the second must give the first's tokens bit for bit; its
    wall time, the busy ticks it charged and their calibrated seconds give
    the scheduler's own host time per tick."""
    first = sched.run(reqs)
    ticks: dict[str, int] = {}
    on_busy = sched.policy.on_busy

    def counted(kind, duration_s):
        ticks[kind] = ticks.get(kind, 0) + 1
        on_busy(kind, duration_s)

    sched.policy.on_busy = counted
    before = runtime.launch_counts().get("int8_matmul", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched.policy.on_busy = on_busy
    if completed(rep) != completed(first):
        fail(f"{what}: a second run of the same scheduler gave other tokens")
    busy = sum(sched.policy.busy_s.values())
    tokens = sum(len(r.tokens) for r in rep.records)
    k5 = runtime.launch_counts().get("int8_matmul", 0) - before
    n = sum(ticks.values())
    return rep, {**run_summary(rep), "wall_s": r6(wall), "busy_ticks": ticks,
                 "calibrated_busy_s": {k: r6(v) for k, v in sched.policy.busy_s.items()},
                 "host_ms_per_tick": r6((wall - busy) / n * 1e3),
                 "int8_matmul": k5, "int8_matmul_per_token": r6(k5 / tokens)}


def scheduler_stream(cfg, service_s: float, tier_mix: float = 0.0):
    return load_mod.poisson_stream(
        SCHED_REQUESTS, rate_hz=SCHED_LOAD / service_s, seed=SCHED_SEED,
        vocab_size=cfg.vocab_size, prompt_lens=SCHED_PROMPTS, new_tokens=SCHED_NEW,
        prompt_period=SCHED_PERIOD, tier_mix=tier_mix)


def reduced_card_vs_cpu(dev) -> dict:
    """The reduced configs of the five cache layouts in f32 through the
    scheduler (chunked admission, speculative verify, seeded NaN faults)
    under one ``FixedCalibration``, on the card and in the port on the CPU:
    every field of the two reports equal, tokens and counters included."""
    out = {}
    for arch in PAGED_ARCHS:
        cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32, quant=None)
        params = tree_map(lambda t: t.float(),
                          init_model(cfg, torch.Generator(dev).manual_seed(0), dev))
        reps = {}
        for where, d, p in (("card", dev, params),
                            ("cpu", "cpu", tree_map(lambda t: t.cpu(), params))):
            eng = engine_mod.InferenceEngine(cfg, params=p, device=d,
                                             sc=engine_mod.ServeConfig(**SCHED_REDUCED_SC))
            reqs = load_mod.poisson_stream(8, rate_hz=40.0, seed=3, vocab_size=cfg.vocab_size,
                                           prompt_lens=(4, 9), new_tokens=(2, 8))
            reps[where] = sched_mod.ContinuousBatchingScheduler(
                eng, policy="idle_waiting", prefill_chunk=4, speculate_k=3,
                calibration=sched_mod.FixedCalibration(**SCHED_FIXED),
                faults=faults_mod.FaultProfile(seed=7, nan_rate=0.1, max_faults=3)).run(reqs)
        # repr: a NaN field (a request never finished) equals itself
        if repr(dataclasses.astuple(reps["card"])) != repr(dataclasses.astuple(reps["cpu"])):
            fail(f"serve_scheduler reduced {arch}: card {run_summary(reps['card'])} "
                 f"{completed(reps['card'])} != cpu {run_summary(reps['cpu'])} "
                 f"{completed(reps['cpu'])}")
        rep = reps["card"]
        out[arch] = {"reports_equal": True, "tokens": sum(len(r.tokens) for r in rep.records),
                     "chunks": rep.chunks, "verify_ticks": rep.verify_ticks,
                     "quarantined": rep.quarantined}
    return out


def drive_serve_scheduler(dev, base) -> dict:
    """The continuous-batching scheduler on ``serve_dense``'s int8
    granite-3-8b (8 layers): a contiguous engine (``ENGINE_SC``) and its
    paged twin (``PAGED_SC``), costs from ``EngineCalibration`` on the card,
    a seeded Poisson stream whose rate is set from them.  Continuous,
    chunked and speculative runs (each twice: tokens equal, the second
    timed) and static batches; the light fault profile; a paged pool of
    half the stream's worst case, preempting by swap and by recompute; a
    power cap under the brownout ladder and an energy budget; the reduced
    configs card against CPU; the launcher."""
    cfg, params = base.cfg, base.params
    contig = engine_mod.InferenceEngine(cfg, params=params, device=dev,
                                        sc=engine_mod.ServeConfig(**ENGINE_SC))
    paged = engine_mod.InferenceEngine(cfg, params=params, device=dev,
                                       sc=engine_mod.ServeConfig(**PAGED_SC))
    report, tokens = {}, []
    with ModelCalls() as log:
        cal = sched_mod.EngineCalibration(contig)
        t0 = time.perf_counter()
        costs = {"step_s": cal.step_s(), "verify_s_4": cal.verify_s(SPEC_K),
                 "prefill_s_1x32": cal.prefill_s(1, 32),
                 "chunk_s_1x16": cal.chunk_s(1, SCHED_CHUNK)}
        calibration_s = time.perf_counter() - t0
        if len(contig._graphs):
            fail("serve_scheduler: calibration left graphs of its pools behind")
        service = load_mod.mean_service_s(cal, prompt_len=32, mean_tokens=16)
        for n in SCHED_PROMPTS:  # outside the timed runs: each length's first timing
            cal.prefill_s(1, n)
        for k in range(1, ENGINE_SC["max_batch"] + 1):
            cal.chunk_s(k, SCHED_CHUNK)
        reqs = scheduler_stream(cfg, service)
        prompts = {r.rid: r.prompt for r in reqs}

        def scheduler(eng, **kw):
            return sched_mod.ContinuousBatchingScheduler(eng, calibration=cal, **kw)

        runs, modes = {}, {}
        for mode, kw in (("continuous", {}), ("chunked", {"prefill_chunk": SCHED_CHUNK}),
                         ("speculative", {"speculate_k": SPEC_K})):
            rep, modes[mode] = timed_run(scheduler(contig, **kw), reqs, f"serve_scheduler {mode}")
            runs[mode] = rep
            tokens.append(modes[mode]["tokens"] * 2)
        base_tokens = completed(runs["continuous"])
        if runs["continuous"].peak_active != ENGINE_SC["max_batch"]:
            fail(f"serve_scheduler: the pool peaked at {runs['continuous'].peak_active} slots")
        if runs["chunked"].chunks < 1 or runs["speculative"].verify_ticks < 1:
            fail("serve_scheduler: no chunk or no verify tick")
        identity = {mode: near_tie_tokens(base_tokens, completed(runs[mode]), prompts, contig,
                                          f"serve_scheduler {mode}")
                    for mode in ("chunked", "speculative")}
        static = sched_mod.run_static_batches(contig, reqs, calibration=cal,
                                              flush_s=16 * service)
        modes["static"] = run_summary(static)
        tokens.append(modes["static"]["tokens"])

        # faults: the light profile, quarantine and retry from committed tokens
        light = faults_mod.make_profile("light", seed=SCHED_FAULT_SEED)
        faulted = scheduler(contig, faults=light).run(reqs)
        tokens.append(sum(len(r.tokens) for r in faulted.records))
        if faulted.quarantined < 1 or faulted.retried < 1 or faulted.failed:
            fail(f"serve_scheduler faults: {run_summary(faulted)}")
        report["faults"] = {**run_summary(faulted), "vs_fault_free": near_tie_tokens(
            base_tokens, completed(faulted), prompts, contig, "serve_scheduler faults")}

        # memory pressure: half the worst case in pages, tiers, swap and recompute
        tiered = scheduler_stream(cfg, service, SCHED_TIER_MIX)
        paged_ref = scheduler(paged).run(tiered)
        tokens.append(sum(len(r.tokens) for r in paged_ref.records))
        paged_tokens = completed(paged_ref)
        tight = engine_mod.InferenceEngine(
            cfg, params=params, device=dev,
            sc=engine_mod.ServeConfig(**PAGED_SC, num_pages=SCHED_PRESSURE_PAGES))
        pressure = {"num_pages": SCHED_PRESSURE_PAGES, "unpressured": run_summary(paged_ref),
                    "vs_contiguous": near_tie_tokens(base_tokens, paged_tokens, prompts, contig,
                                                     "serve_scheduler paged")}
        for swap in (True, False):
            rep = scheduler(tight, preempt="tiered", swap=swap).run(tiered)
            tokens.append(sum(len(r.tokens) for r in rep.records))
            name = "swap" if swap else "recompute"
            if rep.preempted < 1 or rep.failed or rep.shed or (
                    swap and rep.swapped != rep.preempted) or (
                    not swap and rep.recomputed != rep.preempted):
                fail(f"serve_scheduler {name}: {run_summary(rep)}")
            # swap restores the same bytes into fresh pages: exact; a recompute
            # re-prefills the committed context: the near-tie rule
            pressure[name] = {**run_summary(rep), "vs_unpressured": near_tie_tokens(
                paged_tokens, completed(rep), prompts, paged, f"serve_scheduler {name}",
                exact=swap)}
        pressure["host_page_check_fired"] = False  # it raises: the runs above would have failed
        report["memory_pressure"] = pressure

        # power: a cap under the brownout ladder, then an energy budget
        capped = scheduler(contig, brownout="ladder", power=power_mod.PowerEnvelope(
            caps=(power_mod.CapWindow(0.0, math.inf, SCHED_CAP_W),))).run(tiered)
        tokens.append(sum(len(r.tokens) for r in capped.records))
        budget_j = SCHED_BUDGET_IDLE_FLOORS * DEFAULT_CHIP.p_idle_w * SCHED_BUDGET_WINDOW_S
        budgeted = scheduler(engine_mod.InferenceEngine(
            cfg, params=params, device=dev, sc=engine_mod.ServeConfig(
                **ENGINE_SC, energy_budget_j=budget_j, budget_window_s=SCHED_BUDGET_WINDOW_S))
        ).run(reqs)
        tokens.append(sum(len(r.tokens) for r in budgeted.records))
        if capped.cap_violation_ticks or budgeted.peak_budget_window_j > budget_j * (1 + 1e-9):
            fail(f"serve_scheduler power: capped {run_summary(capped)}, budget {budget_j} J: "
                 f"{run_summary(budgeted)} peak {budgeted.peak_budget_window_j}")
        report["power"] = {
            "cap_w": SCHED_CAP_W, "capped": {**run_summary(capped),
                                             "peak_window_w": r6(capped.peak_window_w)},
            "capped_vs_uncapped": near_tie_tokens(base_tokens, completed(capped), prompts,
                                                  contig, "serve_scheduler capped", exact=True),
            "budget_j": r6(budget_j), "budget_window_s": SCHED_BUDGET_WINDOW_S,
            "budgeted": {**run_summary(budgeted),
                         "peak_budget_window_j": r6(budgeted.peak_budget_window_j)},
            "budgeted_vs_unbudgeted": near_tie_tokens(base_tokens, completed(budgeted), prompts,
                                                      contig, "serve_scheduler budget",
                                                      exact=True)}

        report["reduced_card_vs_cpu"] = reduced_card_vs_cpu(dev)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = serve_launcher.main(["--arch", GRANITE, "--mode", "compare", "--paged",
                                        "--n", "12"])
        if code != 0:
            fail(f"serve_scheduler: the launcher returned {code}")
        report["launcher"] = {"argv": f"--arch {GRANITE} --mode compare --paged --n 12",
                              "returned": code, "stdout": out.getvalue().splitlines()}
    report.update(
        arch=GRANITE, layers=cfg.num_layers, quant="int8",
        stream={"requests": SCHED_REQUESTS, "prompt_lens": list(SCHED_PROMPTS),
                "new_tokens": list(SCHED_NEW), "rate_hz": r6(SCHED_LOAD / service),
                "mean_service_s": r6(service), "prompt_period": SCHED_PERIOD,
                "seed": SCHED_SEED},
        calibration={**{k: r6(v * 1e3) for k, v in costs.items()}, "unit": "ms",
                     "seconds_to_calibrate": r6(calibration_s)},
        modes=modes, mode_identity=identity,
        continuous_over_static_items_per_joule=r6(
            runs["continuous"].items_per_joule / static.items_per_joule),
        model_calls=log.calls, graph_replays=log.replays, committed_tokens=sum(tokens))
    return {"expect": {"int8_matmul": log.int8_matmul}, "report": report}


def scheduler_summary(report: dict) -> dict:
    """The ``serve_scheduler`` line: the numbers and verdicts, under 2 KB
    (the whole report goes to ``--out``)."""
    modes = report["modes"]
    mp, pw = report["memory_pressure"], report["power"]
    return {
        "calibration_ms": report["calibration"],
        "beside_replayed_tick": report.get("beside_replayed_tick"),
        "host_ms_per_tick": {m: modes[m]["host_ms_per_tick"]
                             for m in ("continuous", "chunked", "speculative")},
        "items_per_joule": {m: v["items_per_joule"] for m, v in modes.items()},
        "p50_p99_ms": {m: [v["p50_ms"], v["p99_ms"]] for m, v in modes.items()},
        "continuous_over_static": report["continuous_over_static_items_per_joule"],
        "peak_active": modes["continuous"]["peak_active"],
        "chunks": modes["chunked"].get("chunks"), "verify_ticks": modes["speculative"].get(
            "verify_ticks"),
        "flips": {m: len(v["flips"]) for m, v in report["mode_identity"].items()},
        "faults": {k: report["faults"].get(k, 0) for k in ("quarantined", "retried", "failed")},
        "pressure": {k: [mp[k].get("preempted", 0), mp[k].get("swapped", 0),
                         mp[k].get("recomputed", 0), len(mp[k]["vs_unpressured"]["flips"])]
                     for k in ("swap", "recompute")},
        "cap_violation_ticks": pw["capped"].get("cap_violation_ticks", 0),
        "peak_budget_window_j": [pw["budgeted"]["peak_budget_window_j"], pw["budget_j"]],
        "reduced_card_vs_cpu": sorted(report["reduced_card_vs_cpu"]),
        "launcher_returned": report["launcher"]["returned"],
        "int8_matmul": report.get("launches", {}).get("int8_matmul"),
        "int8_matmul_per_committed_token": report.get("int8_matmul_per_committed_token"),
    }


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------
SINGLE_MODES = (False, True, "pallas_step", "pallas_seq", "pallas_seq_q8")
STACK_MODES = ("pallas_stack", "pallas_stack_q8", "pallas_seq", "pallas_seq_q8", "pallas_step",
               False, True)
Q8_VS_F32 = 5e-2   # int8 weights against the f32 path, as the reference's q8 tests


# ---------------------------------------------------------------------------
# The chip model, the block-size tuner and the card's power, on the card
# ---------------------------------------------------------------------------
def check_chip_model(dev) -> dict:
    """``H100Chip``'s data-sheet fields against what the card reports
    (``torch.cuda.get_device_properties``, the cluster kernel's occupancy
    query, ``nvidia-smi``'s power limit).  Fails where a property the card
    reports differs; the memory size may differ by the card's reserve."""
    props = torch.cuda.get_device_properties(dev)
    card = {
        "sms": props.multi_processor_count,
        "smem_per_block": getattr(props, "shared_memory_per_block_optin", None),
        "smem_per_sm": getattr(props, "shared_memory_per_multiprocessor", None),
        "threads_per_sm": getattr(props, "max_threads_per_multi_processor", None),
        "l2_bytes": getattr(props, "L2_cache_size", None),
        "cluster_slots": cluster_slots(dev),
    }
    model = {k: getattr(DEFAULT_CHIP, k) for k in card}
    for k, v in card.items():
        if v is not None and v != model[k]:
            fail(f"H100Chip.{k} = {model[k]}, the card reports {v}")
    total = props.total_memory
    if abs(total - DEFAULT_CHIP.hbm_bytes) > 0.1 * DEFAULT_CHIP.hbm_bytes:
        fail(f"H100Chip.hbm_bytes = {DEFAULT_CHIP.hbm_bytes}, the card has {total}")
    limit = float(smi_query("power.limit"))
    return {"card": card, "model": model, "total_memory": total,
            "hbm_bytes": DEFAULT_CHIP.hbm_bytes, "power_limit_w": limit,
            "p_peak_w": DEFAULT_CHIP.p_peak_w, "runtime": {
                "MAX_SHARED_BYTES": runtime.MAX_SHARED_BYTES, "SM_COUNT": runtime.SM_COUNT}}


def smi_query(field: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of card 0, without units."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def fixed_int8_plan(m: int, k: int, n: int) -> dict:
    """K5's geometry before the tuner (the fixed rule it replaced, passed to
    the wrapper explicitly to compare with): 16-row tiles at decode, K split
    until the grid holds 2 x 132 blocks; 64- or 128-row tiles above, K split
    while the tiles leave SMs idle, chunks of at least 8 stages."""
    if m <= 16:
        block_m, target, min_steps = 16, 2 * runtime.SM_COUNT, 1
        block_n = 128 if n >= 4096 else 64
    elif m <= 64:
        block_m, block_n, target, min_steps = 64, 128, runtime.SM_COUNT, 8
    else:
        block_m, block_n, target, min_steps = 128, 128, runtime.SM_COUNT, 8
    steps = -(-k // int8_mod.BLOCK_K)
    tiles = -(-m // block_m) * -(-n // block_n)
    per = max(steps // -(-target // tiles), min(min_steps, steps), 1)
    return {"block_m": block_m, "block_n": block_n, "block_k": per * int8_mod.BLOCK_K}


def tuner_cases() -> list[tuple]:
    """(kernel, problem, dtype, fixed plan, tolerance, main path?): every
    K2-K6 shape of the main paths, and the chunked LSTM batch of 200 rows,
    where the tuner leaves the fixed plan.  The fixed plans are those of
    the rules the tuner replaced."""
    lw = paper_workload()
    paper = {"batch": PAPER_BATCH, "seq": lw.seq, "d_in": lw.d_in, "hidden": lw.hidden}
    b, s, d, h = QUANT_SHAPE
    wide = {"batch": b, "seq": s, "d_in": d, "hidden": h}
    chunky = dict(zip(("batch", "seq", "d_in", "hidden"), CHUNK_SHAPE))
    cases = [("lstm_cell", {"batch": b, "d_in": d, "hidden": h}, "float32", {"block_b": 10},
              TOL_F32, True),
             ("lstm_cell", {"batch": PAPER_BATCH, "d_in": lw.d_in, "hidden": lw.hidden},
              "float32", {"block_b": 2}, TOL_F32, True)]
    for dtype, tol in (("float32", TOL_F32), ("int8", TOL_Q8)):
        cases += [("lstm_seq", wide, dtype, {"block_b": 3}, tol, True),
                  ("lstm_seq", paper, dtype, {"block_b": 1}, tol, True),
                  ("lstm_seq", chunky, dtype, {"block_b": 14}, tol, False),
                  ("lstm_stack", {**wide, "layers": STACK_SHAPE[4]}, dtype, {"block_b": 3}, tol,
                   True),
                  ("lstm_stack", {**chunky, "layers": STACK_SHAPE[4]}, dtype, {"block_b": 14},
                   tol, False)]
    for m in (4, 20, 32, 64, 256):
        for k, n in INT8_PROJ_KN:
            cases.append(("int8_matmul", {"m": m, "k": k, "n": n}, "int8",
                          fixed_int8_plan(m, k, n), 0.0, True))
    # the expert einsums, one launch over E: the fixed plan is the one the
    # rule gives a single product of the shape (a split of K that fills the
    # card for one product, over-split when E products share the grid)
    for e, m, k, n, _ in INT8_BATCHED:
        cases.append(("int8_matmul", {"m": m, "k": k, "n": n, "batch": e}, "int8",
                      fixed_int8_plan(m, k, n), 0.0, True))
    # whisper-tiny's and internvl2-76b's projections at the row counts their
    # paths launch: decode (4), whisper's encoder over one and four requests'
    # 1500 frames; internvl2's verify (4 x 5), a chunk of 2 x 48, one prompt
    # of 320 positions and four
    for ms, kns in ((WHISPER_K5_M, WHISPER_K5_KN), (VLM_K5_M, VLM_K5_KN)):
        for m in ms:
            for k, n in kns:
                cases.append(("int8_matmul", {"m": m, "k": k, "n": n}, "int8",
                              fixed_int8_plan(m, k, n), 0.0, True))
    fb, fh, _, fsq, fsk, fd, _, _ = FLASH_MAIN
    flash = {"b": fb, "h": fh, "sq": fsq, "sk": fsk, "d": fd}
    cases += [("flash_attention", flash, "bfloat16", {"block_q": 64, "block_k": 64}, TOL_BF16,
               True)]
    return cases


TUNER_TOP = 6    # analytic candidates timed beside the pick and the fixed plan


def tuner_case(dev, kernel, problem, dtype, fixed, tol, main_path) -> dict:
    """One shape: the analytic pick and the fixed plan (device times taken
    in turns, pick, plan, plan, pick, pick, plan, and the median of each),
    the analytic top ``TUNER_TOP`` and the probes, the measured refinement
    over the top 3 (``bench.make_measure_fn``), each output held to the
    plain version, and the tuner's own host time with a cold disk cache, a
    warm process and a warm disk.  K5 is timed with its weight read from
    device memory (``cold_device_ms``), as the serving path reads it."""
    from repro_torch.kernels import autotune

    chip = autotune.chip_with_slots(cluster_slots(dev) if kernel.startswith("lstm_s") else None)
    backend = runtime.CUDA_BACKEND
    autotune.clear_cache(disk=True)
    t0 = time.perf_counter()
    pick = autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip)
    t1 = time.perf_counter()
    autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip)
    t2 = time.perf_counter()
    autotune.clear_cache()
    autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip)
    t3 = time.perf_counter()
    ranked = autotune.ranked_candidates(kernel, problem, dtype=dtype, chip=chip)
    if ranked[0] != pick:
        fail(f"tuner {kernel} {problem}: autotune gave {pick}, the ranking {ranked[0]}")
    run, plain = bench.candidate_calls(kernel, problem, dtype, dev, seed=500)
    timer = lambda c: device_ms(run(c), reps=5)  # noqa: E731
    if kernel == "int8_matmul":  # from device memory, as the serving path reads its weights
        m, k, n, e = problem["m"], problem["k"], problem["n"], problem.get("batch")
        xq, wq, sx, sw = (batched_int8_operands(e, m, k, n, dev, 500, False) if e
                          else int8_operands(m, k, n, dev, 500))
        run = lambda c: lambda: (int8_matmul(xq, wq, sx, sw, **c),)  # noqa: E731
        plain = lambda: (int8_matmul_plain(xq, wq, sx, sw),)  # noqa: E731
        timer = lambda c: cold_device_ms(lambda w: int8_matmul(xq, w, sx, sw, **c), wq)  # noqa: E731
    want = plain()

    def checked(c):
        got = run(c)()
        err = max(compare(g, w, "exact", tol, f"tuner {kernel} {problem} {dtype} {c}")
                  if tol else exact(g, w, f"tuner {kernel} {problem} {c}")
                  for g, w in zip(got, want))
        return err

    timed = []
    for c in [pick, fixed] + ranked[:TUNER_TOP] + tuner_probes(kernel, problem, ranked):
        if c not in timed:
            timed.append(c)
    rows = {}
    for c in timed:
        rows[json.dumps(c, sort_keys=True)] = {
            "candidate": c, "max_abs_err": r6(checked(c)),
            "predicted_us": r6(autotune.predict_time_s(kernel, problem, c, dtype=dtype,
                                                       chip=chip) * 1e6),
            "device_ms": r6(timer(c))}
    turns = {"pick": [], "fixed": []}
    for side in ("pick", "fixed", "fixed", "pick", "pick", "fixed"):
        t = timer(pick if side == "pick" else fixed)
        if t is not None:
            turns[side].append(t)
    pick_ms = statistics.median(turns["pick"]) if turns["pick"] else None
    fixed_ms = statistics.median(turns["fixed"]) if turns["fixed"] else None
    measured = autotune.autotune(kernel, problem, dtype=dtype, backend=backend, chip=chip,
                                 measure_fn=bench.make_measure_fn(kernel, problem, dtype, dev),
                                 top_k=3)
    measured_key = json.dumps(measured, sort_keys=True)
    if measured_key not in rows:
        fail(f"tuner {kernel} {problem}: measured winner {measured} not among the top 3")
    autotune.clear_cache(disk=True)
    return {"kernel": kernel, "problem": problem, "dtype": dtype, "main_path": main_path,
            "tolerance": tol, "pick": pick, "fixed": fixed, "same_as_fixed": pick == fixed,
            "pick_device_ms": r6(pick_ms), "fixed_device_ms": r6(fixed_ms),
            "pick_over_fixed": r6(None if None in (pick_ms, fixed_ms) else pick_ms / fixed_ms),
            "measured_winner": measured, "measured_device_ms": rows[measured_key]["device_ms"],
            "autotune_us": {"cold": r6((t1 - t0) * 1e6), "warm": r6((t2 - t1) * 1e6),
                            "disk": r6((t3 - t2) * 1e6)},
            "candidates": list(rows.values())}


def tuner_summary(tuner: dict) -> dict:
    """The ``tuner`` line: each case without its candidate table (which
    ``--out`` keeps)."""
    return {**tuner, "cases": [{k: v for k, v in c.items() if k != "candidates"}
                               for c in tuner["cases"]]}


TUNER_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def tuner_probes(kernel, problem, ranked) -> list[dict]:
    """Candidates timed besides the analytic top, so that the fit in the
    ``tuner`` line sees the whole range: K5's tiles at 1 to 32 chunks of K
    (those the tuner takes), and every LSTM tile that fits up to 16 rows."""
    from repro_torch.kernels import autotune

    if kernel == "int8_matmul":
        steps = -(-problem["k"] // int8_mod.BLOCK_K)
        tiles = sorted({(c["block_m"], c["block_n"]) for c in ranked})
        chunks = set(autotune.k_chunks(problem["k"]))
        probes = [{"block_m": bm, "block_n": bn, "block_k": -(-steps // s) * int8_mod.BLOCK_K}
                  for bm, bn in tiles for s in TUNER_SPLITS if s <= steps]
        return [c for c in probes if c["block_k"] in chunks]
    if kernel.startswith("lstm"):
        return [c for c in ranked if c["block_b"] <= 16]
    return []


def nonnegative_lstsq(a: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with every coefficient >= 0: features whose coefficient
    comes out negative are dropped and the rest refitted."""
    keep = np.ones(a.shape[1], dtype=bool)
    while True:
        x = np.zeros(a.shape[1])
        x[keep] = np.linalg.lstsq(a[:, keep], y, rcond=None)[0]
        if (x >= 0).all():
            return x
        keep &= x > 0


def tuner_fit(cases) -> dict:
    """The tuner's linear fits (``autotune.features``) refitted to this
    run's timings, relative error minimised, beside the committed fit."""
    from repro_torch.kernels import autotune

    groups: dict[str, list] = {}
    for case in cases:
        chip = autotune.chip_with_slots(
            DEFAULT_CHIP.cluster_slots if case["kernel"].startswith("lstm_s") else None)
        for row in case["candidates"]:
            f = autotune.features(case["kernel"], case["problem"], row["candidate"],
                                  dtype=case["dtype"], chip=chip)
            if f is not None and row["device_ms"]:
                groups.setdefault(f[0], []).append((f[1], row["device_ms"] * 1e-3))
    out = {}
    for name, rows in sorted(groups.items()):
        a = np.array([r[0] for r in rows], dtype=np.float64)
        y = np.array([r[1] for r in rows])
        refit = nonnegative_lstsq(a / y[:, None], np.ones(len(y)))
        committed = np.array(autotune.FITS[name])
        rms = lambda x: float(np.sqrt(np.mean(((a @ x - y) / y) ** 2)))  # noqa: E731
        out[name] = {"samples": len(rows), "refit": [float(f"{v:.4g}") for v in refit],
                     "committed": [float(f"{v:.4g}") for v in committed],
                     "rms_rel_refit": r6(rms(refit)), "rms_rel_committed": r6(rms(committed))}
    return out


def exact(got, want, what: str) -> float:
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"{what}: not bit-identical to the plain version")
    return 0.0


def check_tuner(dev) -> dict:
    """Every case of :func:`tuner_cases` in a cache directory of its own,
    which is removed after, so that no measured winner reaches the paths
    driven later (their "auto" is the analytic pick)."""
    import os
    import tempfile

    from repro_torch.kernels import autotune

    saved = os.environ.get("REPRO_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = str(pathlib.Path(tmp) / "autotune.json")
        try:
            cases = [tuner_case(dev, *case) for case in tuner_cases()]
        finally:
            autotune.clear_cache()
            if saved is None:
                os.environ.pop("REPRO_AUTOTUNE_CACHE")
            else:
                os.environ["REPRO_AUTOTUNE_CACHE"] = saved
    main = [c for c in cases if c["main_path"] and c["pick_over_fixed"] is not None]
    return {"model": autotune.MODEL, "fit": tuner_fit(cases), "cases": cases,
            "main_path_shapes": len(main),
            "same_as_fixed": sum(c["same_as_fixed"] for c in main),
            "worst_pick_over_fixed": r6(max(c["pick_over_fixed"] for c in main)),
            "over_1_03": [[c["kernel"], c["problem"], c["dtype"], c["pick_over_fixed"]]
                          for c in main if c["pick_over_fixed"] > 1.03]}


ENERGY_LOOP_S = 2.0


def sample_power(stop, out: list, period: float = 0.1) -> None:
    while not stop.is_set():
        out.append(float(smi_query("power.draw")))
        stop.wait(period)


def idle_power(settle_s: float) -> list[float]:
    """``power.draw`` of the idle card (its context held): 10 samples 0.2 s
    apart, after ``settle_s`` seconds of nothing."""
    torch.cuda.synchronize()
    time.sleep(settle_s)
    idle = []
    for _ in range(10):
        idle.append(float(smi_query("power.draw")))
        time.sleep(0.2)
    return idle


def power_while(fn, seconds: float) -> tuple[list, int, float]:
    """``power.draw`` samples (``sample_power``'s thread) while ``fn`` runs
    back to back for at least ``seconds``; returns the samples, the calls
    and the seconds."""
    import threading

    busy, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_power, args=(stop, busy))
    calls, t0 = 0, time.perf_counter()
    sampler.start()
    try:
        while time.perf_counter() - t0 < seconds:
            fn()
            calls += 1
    finally:
        stop.set()
        sampler.join()
    return busy, calls, time.perf_counter() - t0


def measure_energy(dev) -> dict:
    """``power.draw`` of the idle card and during a 2 s loop of K3 at
    ``QUANT_SHAPE`` (f32), beside ``H100Chip.step_power`` at that loop's
    utilisation (its operations over the f32 peak); the L2 rate (a 16 MB
    device copy, read + write); and the two "configuration" constants: a
    pinned host-to-device copy of one ``serve_dense`` layer's int8
    projections, and, in a fresh process, loading the built kernel library
    plus a first launch."""
    chip = DEFAULT_CHIP
    idle = idle_power(3.0)
    b, s, d, h = QUANT_SHAPE
    x, params = make_lstm(70, b, s, d, h, 1, dev)
    p = params[0]
    fn = lambda: lstm_seq_fused(x, p["w"], p["u"], p["b"])  # noqa: E731
    fn()
    torch.cuda.synchronize()

    def burst():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()

    busy, bursts, loop_s = power_while(burst, ENERGY_LOOP_S)
    calls = 50 * bursts
    call_ms = loop_s / calls * 1e3
    util = lstm_flops(b, s, d, h) / (call_ms * 1e-3) / PEAK_F32_FLOPS
    # L2: 8 MB read and 8 MB written per copy, both within the 50 MB L2
    src = torch.empty(8 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    l2_ms = time_ms(lambda: dst.copy_(src), reps=200)
    # one serve_dense layer's int8 projections, pinned, to the card
    cfg = get_config(GRANITE)
    hd = cfg.resolved_head_dim
    layer_bytes = cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
        + cfg.num_heads * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    host = torch.empty(layer_bytes, dtype=torch.uint8).pin_memory()
    card = torch.empty(layer_bytes, dtype=torch.uint8, device=dev)
    copy_ms = time_ms(lambda: card.copy_(host, non_blocking=True), reps=5, rounds=5)
    del host, card
    probe = ("import sys, time, torch; sys.path.insert(0, 'src');"
             "from repro_torch.kernels import runtime;"
             "from repro_torch.kernels.activations import activation;"
             "x = torch.zeros(1024, device='cuda'); torch.cuda.synchronize();"
             "t0 = time.perf_counter(); runtime.load_kernels(); activation(x);"
             "torch.cuda.synchronize(); print(time.perf_counter() - t0)")
    root = pathlib.Path(__file__).resolve().parent
    fixed_s = float(subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                                   text=True, check=True, timeout=120).stdout.strip())
    idle_w = statistics.median(idle)
    busy_w = statistics.median(busy) if busy else None
    return {"gpu": smi_query("name") + ", " + smi_query("power.limit") + " W",
            "idle_w": r6(idle_w), "idle_samples": idle,
            "k3_loop": {"shape": list(QUANT_SHAPE), "seconds": r6(loop_s), "calls": calls,
                        "call_ms": r6(call_ms), "utilisation_f32": r6(util),
                        "power_draw_w": r6(busy_w), "samples": len(busy),
                        "step_power_w": r6(chip.step_power(util)),
                        "energy_per_call_mj": r6(None if busy_w is None else busy_w * call_ms)},
            "l2_copy": {"bytes_moved": 2 * src.numel(), "ms": r6(l2_ms),
                        "bytes_per_s": r6(2 * src.numel() / (l2_ms * 1e-3))},
            "reload": {"layer_bytes": layer_bytes, "pinned_copy_ms": r6(copy_ms),
                       "bytes_per_s": r6(layer_bytes / (copy_ms * 1e-3)),
                       "library_load_and_first_launch_s": r6(fixed_s)},
            "model": {"p_idle_w": chip.p_idle_w, "p_peak_w": chip.p_peak_w,
                      "reload_bw": chip.reload_bw, "reload_fixed_s": chip.reload_fixed_s}}


# ---------------------------------------------------------------------------
# train: the training path (Trainer, checkpoints, restarts) at full width
# ---------------------------------------------------------------------------
TRAIN_LAYERS = 8                    # granite-3-8b's only cut, as serve_dense's
TRAIN_BATCH, TRAIN_SEQ = 2, 4096    # train_4k's length; its global batch of 256 is a pod's
TRAIN_STEPS, TRAIN_FAIL_AT = 8, 4
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
SSM_TRAIN = {"arch": "mamba2-780m", "batch": 1, "seq": 4096, "steps": 4, "lr": 1e-3}
TRAIN_REPLAY_TOL = 1e-2             # a replayed loss against the first run's, relative
TRAIN_ACCUM_TOL = 2e-2              # accum=2 against accum=1: bf16 grads summed apart
TRAIN_REDUCED_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "step": 1e-5}
TRAIN_DIR = pathlib.Path(__file__).resolve().parent / "build" / "train_ckpt"


EXAMPLES_DIR = pathlib.Path(__file__).resolve().parent / "examples" / "torch"


def example(name: str):
    """``examples/torch/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FanInTrainer(train_loop_mod.Trainer):
    """The Trainer with its random attention weights at std 1/sqrt(fan-in)
    (``attention_fan_in``, as the serving paths draw them).  With the
    reference's draw (std 1/sqrt(heads) for wq, wk, wv) attention is nearly
    one-hot, the gradient norm of granite-3-8b at 8 layers is ~1e8 and its
    loss does not fall in 8 steps at any learning rate: the reference's
    model behaves so too, on the CPU at narrower widths."""

    def _init_params(self, keep):
        params = super()._init_params(keep)  # on a mesh the rank's blocks: scaled alike
        attention_fan_in(params, self.cfg)
        return params


def state_digest(tree) -> list[int]:
    """A checksum of each leaf's bits: the sum over its elements of the bits
    as an integer times (position mod 65521) + 1, in int64 (wrapping).
    Integer sums are exact in any order, so equal digests mean equal bits
    but for a collision."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tree_flatten(tree):
        bits = t.detach().reshape(-1).view(ints[t.element_size()])
        total = 0
        for start in range(0, bits.numel(), 1 << 26):
            chunk = bits[start:start + (1 << 26)].to(torch.int64)
            w = (torch.arange(start, start + chunk.numel(), device=chunk.device) % 65521) + 1
            total += int((chunk * w).sum())
        out.append(total)
    return out


def matmul_params(cfg) -> int:
    """Parameters that take part in a product: all but an untied input
    embedding table (a lookup)."""
    n = cfg.param_count()
    return n if cfg.tie_embeddings else n - cfg.padded_vocab * cfg.d_model


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one step: 6·N·tokens, N the matmul params, plus the
    causal attention's score and value products, 6·L·H·hd·S² a sequence
    (the half of the S² scores a causal mask keeps; forward and backward).
    Remat's recompute is not counted; nor is the SSD scan's own work."""
    tokens = batch * seq
    attn = 0.0
    if cfg.num_heads:
        attn = 6.0 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim * seq * seq * batch
    return 6.0 * matmul_params(cfg) * tokens + attn


def train_numbers(cfg, trainer, rows: list, batch: int, seq: int, peak: int) -> dict:
    """Step time (median over the steps after the first), tokens/s, MFU
    against the bf16 peak, peak memory beside the analytic state bytes."""
    times = [r["time_s"] for r in rows if r["step"] > 0]
    step_s = statistics.median(times)
    n = cfg.param_count()
    state = tree_bytes(trainer._state())
    return {"params": n, "step_s_median": r6(step_s), "step_s": [r6(t) for t in times],
            "tokens_per_s": r6(batch * seq / step_s),
            "model_tflop_per_step": r6(train_flops(cfg, batch, seq) / 1e12),
            "mfu_bf16": r6(train_flops(cfg, batch, seq) / step_s / PEAK_BF16_FLOPS),
            "max_memory_allocated_gb": r6(peak / 1e9),
            "state_gb": r6(state / 1e9),
            "state_gb_analytic": r6(n * (2 + 12) / 1e9),
            "state_and_grads_gb_analytic": r6(n * 16 / 1e9)}


@contextlib.contextmanager
def batches_recorded(seen: list):
    """Every batch the Trainer draws, as (step, tokens on the host)."""
    real = train_loop_mod.make_batch

    def recording(cfg, ds, step, **kw):
        batch = real(cfg, ds, step, **kw)
        seen.append((step, batch["tokens"].cpu()))
        return batch

    train_loop_mod.make_batch = recording
    try:
        yield
    finally:
        train_loop_mod.make_batch = real


def replayed_batches_equal(seen: list) -> int:
    """How many steps drew their batch twice; fails unless each replay drew
    the same tokens bit for bit."""
    first, replays = {}, 0
    for step, toks in seen:
        if step in first:
            replays += 1
            if not torch.equal(first[step], toks):
                fail(f"train: the replayed batch of step {step} differs")
        first[step] = toks
    return replays


def trainer_config(name: str, steps: int, **kw):
    return train_loop_mod.TrainerConfig(
        num_steps=steps, log_every=1, checkpoint_dir=str(TRAIN_DIR / name), **kw)


def losses_finite(rows: list, what: str, falling: bool) -> dict:
    """Fails on a non-finite loss or gradient norm at any step (one
    non-finite gradient entry makes the norm so), and with ``falling`` on a
    last loss not under the first."""
    losses = [r["loss"] for r in rows]
    norms = [r["grad_norm"] for r in rows]
    if not all(math.isfinite(v) for v in losses + norms):
        fail(f"{what}: a non-finite loss or gradient norm: {losses} {norms}")
    if falling and not losses[-1] < losses[0]:
        fail(f"{what}: the loss did not fall ({losses[0]} → {losses[-1]})")
    return {"loss_first": r6(losses[0]), "loss_last": r6(losses[-1]),
            "grad_norms": [r6(v) for v in norms]}


def watch_restores(trainer) -> dict:
    """Wraps the Trainer's checkpoint save and its restore: each save's step
    (a periodic checkpoint or a straggler snapshot) and for each restore the
    step it resumes at, its seconds, the ``state_digest`` of the state after
    it, and the latest save before it with the digest of the state that save
    was handed go into the dict returned."""
    seen = {"saves": [], "restores": []}
    save, restore = trainer.ckpt.save, trainer._restore
    last = {}

    def save_and_digest(step, tree, **kw):
        seen["saves"].append(step)
        last.update(step=step, digest=state_digest(tree))
        return save(step, tree, **kw)

    def timed_restore():
        before = dict(last)
        t = time.perf_counter()
        out = restore()
        seen["restores"].append({"to_step": out, "seconds": r6(time.perf_counter() - t),
                                 "digest": state_digest(trainer._state()),
                                 "saved_step": before.get("step"),
                                 "saved_digest": before.get("digest")})
        return out

    trainer.ckpt.save, trainer._restore = save_and_digest, timed_restore
    return seen


def train_dense(dev) -> dict:
    """granite-3-8b at full width, 8 layers, 2 x 4096 tokens: the Trainer
    for 8 steps with a WorkerFailure at step 4, before any checkpoint (one
    restart from the seeded init, steps 0-3 replayed: the same batches bit
    for bit, the same losses within TRAIN_REPLAY_TOL), its final checkpoint
    restored into a fresh Trainer (every leaf bit for bit the first's);
    accum=2 against accum=1 on one batch; one profiled step.  One
    checkpoint only: the state is 28 GB, and the run keeps its disk writes
    under 45 GiB (a mid-run checkpoint and its replay run on granite-4m in
    ``train_converge``)."""
    cfg = dataclasses.replace(get_config(GRANITE), num_layers=TRAIN_LAYERS)
    ds = data_mod.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, seed=0)
    tc = trainer_config("dense", TRAIN_STEPS, checkpoint_every=TRAIN_STEPS, keep=1,
                        peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    t0 = time.perf_counter()
    first = FanInTrainer(cfg, ds, tc, device=dev)
    init_s = time.perf_counter() - t0
    first._failure_at = TRAIN_FAIL_AT
    seen = []
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with batches_recorded(seen):
        stats = first.run()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    rows = stats["metrics"]
    steps = [r["step"] for r in rows]
    if stats["restarts"] != 1 or steps != list(range(TRAIN_FAIL_AT)) + list(range(TRAIN_STEPS)):
        fail(f"train_dense: restarts {stats['restarts']}, steps {steps}")
    replays = replayed_batches_equal(seen)
    errs = [abs(rows[TRAIN_FAIL_AT + s]["loss"] - rows[s]["loss"]) / abs(rows[s]["loss"])
            for s in range(TRAIN_FAIL_AT)]
    if max(errs) > TRAIN_REPLAY_TOL:
        fail(f"train_dense: replayed losses {[r['loss'] for r in rows]}")
    out = {"layers": TRAIN_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
           "dtype": str(cfg.dtype), "optimizer": cfg.optimizer, "init_s": r6(init_s),
           "run_s": r6(run_s), "restarts": stats["restarts"],
           "replayed_batches_bitwise": replays, "replayed_loss_rel_err": [r6(e) for e in errs]}
    out.update(train_numbers(cfg, first, rows, TRAIN_BATCH, TRAIN_SEQ, peak))
    out.update(losses_finite(rows[TRAIN_FAIL_AT:], "train_dense", falling=True))

    # a fresh Trainer restores the final checkpoint: every leaf bit for bit
    torch.cuda.empty_cache()
    fresh = FanInTrainer(cfg, ds, tc, device=dev)
    t0 = time.perf_counter()
    if fresh._restore() != TRAIN_STEPS:
        fail("train_dense: the fresh Trainer did not restore the final checkpoint")
    restore_s = time.perf_counter() - t0
    pairs = list(zip(tree_flatten(first._state()), tree_flatten(fresh._state())))
    unequal = sum(not torch.equal(a, b) for a, b in pairs)
    if unequal:
        fail(f"train_dense: {unequal} leaves of the restored state differ from the trainer's")
    out["fresh_trainer"] = {"restore_s": r6(restore_s), "leaves": len(pairs),
                            "leaves_bitwise_equal": len(pairs) - unequal,
                            "checkpoint_gb": r6(tree_bytes(fresh._state()) / 1e9)}
    del first, pairs
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR / "dense", ignore_errors=True)

    # one more step of the restored state, the card's peak over it alone (held to its trace)
    batch = fresh.batch(TRAIN_STEPS)
    _, out["step_peak"] = step_peak(dev, lambda: fresh.step_fn(
        fresh.params, fresh.opt_state, batch, TRAIN_STEPS), fresh._state(), batch)
    del batch

    # accum=2 against accum=1 on the same batch (no update)
    batch = data_mod.make_batch(cfg, ds, 0, device=dev)
    l1, _, g1 = train_loop_mod.loss_and_grads(cfg, fresh.params, batch, 1)
    n1 = float(optimizer_mod.global_norm(g1))
    l2, _, g2 = train_loop_mod.loss_and_grads(cfg, fresh.params, batch, 2)
    n2 = float(optimizer_mod.global_norm(g2))
    leaf_err = max(float((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_flatten(g1), tree_flatten(g2)))
    del g1, g2
    accum = {"loss_1": r6(float(l1)), "loss_2": r6(float(l2)), "grad_norm_1": r6(n1),
             "grad_norm_2": r6(n2), "worst_leaf_err_of_leaf_max": r6(leaf_err),
             "loss_and_norm_tolerance": TRAIN_ACCUM_TOL}
    if abs(float(l2) - float(l1)) > TRAIN_ACCUM_TOL * abs(float(l1)) or \
            abs(n2 - n1) > TRAIN_ACCUM_TOL * n1:
        fail(f"train_dense: accum=2 against accum=1: {accum}")
    out["accum"] = accum
    out["profile"] = train_profile(fresh, cfg, ds, out["step_s_median"])
    return out


def train_profile(trainer, cfg, ds, step_s: float) -> dict:
    """One train step under ``torch.profiler`` (``profile_call``: wall,
    device busy, the largest kernels).  The profiler slows the host, so the
    idle share is given twice: of the profiled wall, and of the median
    unprofiled step (``step_s``), 1 - busy / step_s."""
    batch = data_mod.make_batch(cfg, ds, 0, device=trainer.device)
    step = lambda: trainer.step_fn(trainer.params, trainer.opt_state, batch, 1)  # noqa: E731
    prof = profile_call(step)
    out = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_span_ms", "idle_share",
                                "device_launches", "top_kernels_ms")}
    out["idle_share_of_unprofiled_step"] = r6(1.0 - prof["device_busy_ms"] / 1e3 / step_s)
    return out


def train_ssm(dev) -> dict:
    """mamba2-780m at full width and depth, batch 1 x 4096, 4 steps: the
    loss and every gradient finite at every step (a finite global norm)."""
    cfg = get_config(SSM_TRAIN["arch"])
    ds = data_mod.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SSM_TRAIN["seq"],
                              global_batch=SSM_TRAIN["batch"], seed=1)
    tc = trainer_config("ssm", SSM_TRAIN["steps"], checkpoint_every=SSM_TRAIN["steps"], keep=1,
                        peak_lr=SSM_TRAIN["lr"], warmup_steps=TRAIN_WARMUP)
    torch.cuda.empty_cache()
    trainer = train_loop_mod.Trainer(cfg, ds, tc, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for step in range(SSM_TRAIN["steps"]):  # no final checkpoint: nothing here reads one
        trainer._do_step(step)
    peak = torch.cuda.max_memory_allocated(dev)
    rows = trainer.metrics_log
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": SSM_TRAIN["batch"],
           "seq": SSM_TRAIN["seq"], "steps": len(rows), "remat": cfg.remat}
    out.update(losses_finite(rows, "train_ssm", falling=False))
    out.update(train_numbers(cfg, trainer, rows, SSM_TRAIN["batch"], SSM_TRAIN["seq"], peak))
    out["profile"] = train_profile(trainer, cfg, ds, out["step_s_median"])
    del trainer
    shutil.rmtree(TRAIN_DIR / "ssm", ignore_errors=True)
    return out


def reduced_step_errors(cpu, card, lr: float) -> dict:
    """Each updated param leaf on the card against the CPU's (``cpu`` and
    ``card`` are (params, state) after one step).  A first AdamW step is
    lr·g / (|g| + eps): where |g| is near eps or 0, the leaf's gradient
    difference between the two devices, d (read from the first moments,
    (1 - b1)·g), moves it by up to lr·d·eps / (|g| - d + eps)², at most
    2·lr; each entry is held to that plus TRAIN_REDUCED_TOL["step"] of the
    leaf's magnitude.  Adafactor's step is continuous in g: the leaf's
    magnitude rule alone."""
    (cp, cs), (gp, gs) = cpu, card
    moments = "m" in cs
    worst_excess, worst_grad, top = 0.0, 0.0, 0.0
    leaves = zip(tree_flatten(gp), tree_flatten(cp),
                 *((tree_flatten(gs["m"]), tree_flatten(cs["m"])) if moments else ()))
    for a, b, *m in leaves:
        err = (a.cpu() - b).abs().double()
        tol = TRAIN_REDUCED_TOL["step"] * float(b.abs().max().clamp_min(1e-30))
        if moments:
            g_card = m[0].cpu().double() / (1 - optimizer_mod.ADAM_B1)
            g_cpu = m[1].double() / (1 - optimizer_mod.ADAM_B1)
            d = float((g_card - g_cpu).abs().max())
            worst_grad, top = max(worst_grad, d), max(top, float(g_cpu.abs().max()))
            eps = optimizer_mod.ADAM_EPS
            near = (g_cpu.abs() - d).clamp_min(0) + eps
            tol = tol + lr * torch.clamp_max(d * eps / near ** 2, 2.0)
        worst_excess = max(worst_excess, float((err - tol).max()))
    return {"max_err_over_tolerance": worst_excess,
            "grad_diff_of_largest_grad": worst_grad / top if top else 0.0}


def train_reduced(dev) -> dict:
    """All ten reduced configs in f32 (TF32 off): one ``make_train_step`` step
    from the same weights and batch on the card and on the CPU."""
    out = {}
    for arch in list_archs():
        cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
        params = tree_map(lambda t: t.float(), init_model(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        ds = data_mod.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3)
        batch = data_mod.make_batch(cfg, ds, 0, device="cpu")
        sched = optimizer_mod.Schedule(peak_lr=1e-3, warmup_steps=0, total_steps=10)
        step = train_loop_mod.make_train_step(cfg, sched)
        res = {}
        for where in ("cpu", dev):
            p = tree_map(lambda t: t.to(where, copy=True), params)
            s = optimizer_mod.init_opt_state(cfg.optimizer, model_mod.param_defs(cfg), p)
            res[str(where)] = step(p, s, {k: v.to(where) for k, v in batch.items()}, 3)
        (cp, cs, cm), (gp, gs, gm) = res["cpu"], res[str(dev)]
        loss_err = abs(float(gm["loss"]) - float(cm["loss"])) / abs(float(cm["loss"]))
        norm_err = abs(float(gm["grad_norm"]) - float(cm["grad_norm"])) / float(cm["grad_norm"])
        errs = reduced_step_errors((cp, cs), (gp, gs), float(cm["lr"]))
        row = {"loss": r6(float(cm["loss"])), "loss_rel_err": r6(loss_err),
               "grad_norm_rel_err": r6(norm_err), "optimizer": cfg.optimizer,
               **{k: r6(v) for k, v in errs.items()}}
        if (loss_err > TRAIN_REDUCED_TOL["loss"] or norm_err > TRAIN_REDUCED_TOL["grad_norm"]
                or errs["max_err_over_tolerance"] > 0
                or not math.isfinite(float(gm["grad_norm"]))):
            fail(f"train_reduced {arch}: card against CPU {row}")
        out[arch] = row
    out["tolerance"] = TRAIN_REDUCED_TOL
    return out


def train_converge(dev) -> dict:
    """``examples/torch/train_lm.py --quick`` on the card, its own Trainer
    (``make_trainer``) and verdict (``report``): granite-4m, 300 steps of
    16 x 128 tokens with a failure at 150, which restores the latest save
    before it, the checkpoint of step 100 or a straggler snapshot taken after
    it (its ``state_digest`` that of the state the save was handed), and
    replays; the final loss must be under 0.6 ln V, the example's own
    criterion.  The example's table goes to the report, not to stdout."""
    ex = example("train_lm")
    args = ex.parse(["--quick", "--device", str(dev),
                     "--ckpt-dir", str(TRAIN_DIR / "converge")])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer, fail_at = ex.make_trainer(args)
    tc, cfg = trainer.tc, trainer.cfg
    periodic = (fail_at - 1) // tc.checkpoint_every * tc.checkpoint_every
    watch = watch_restores(trainer)
    t0 = time.perf_counter()
    stats = trainer.run()
    run_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(printed):
        ok = ex.report(trainer, stats)
    final = stats["metrics"][-1]["loss"]
    limit = ex.CRITERION * math.log(cfg.vocab_size)
    if stats["restarts"] != 1 or not ok or not final < limit:
        fail(f"train_converge: restarts {stats['restarts']}, final loss {final} (limit {limit})")
    # the restore resumes after the latest save before the failure: step
    # ``periodic``'s checkpoint, or a straggler snapshot the detector took
    # after it (a save on its thread can slow the steps that follow)
    restores, saves = watch["restores"], watch["saves"]
    saved = restores[0]["saved_step"] if len(restores) == 1 else None
    snapshots = [s for s in saves if s % tc.checkpoint_every and s != tc.num_steps - 1]
    if (periodic not in saves or saved is None or saved < periodic
            or [r["to_step"] for r in restores] != [saved + 1]
            or restores[0]["digest"] != restores[0]["saved_digest"]):
        fail(f"train_converge: the state restored is not that of the save before the "
             f"failure (saves at {saves}): restores to {[r['to_step'] for r in restores]} "
             f"after saves at {[r['saved_step'] for r in restores]}, digest equal "
             f"{[r['digest'] == r['saved_digest'] for r in restores]}")
    shutil.rmtree(TRAIN_DIR / "converge", ignore_errors=True)
    return {"example": "examples/torch/train_lm.py --quick", "model": cfg.name,
            "params": cfg.param_count(), "steps": tc.num_steps, "failure_at": fail_at,
            "restarts": stats["restarts"], "restored_step": saved,
            "straggler_snapshots": snapshots,
            "restore_s": restores[0]["seconds"], "restored_digest_equal": True,
            "loss_first": r6(stats["metrics"][0]["loss"]),
            "loss_final": r6(final), "limit_0.6_lnV": r6(limit),
            "bigram_floor_ln4": r6(math.log(4)), "run_s": r6(run_s),
            "printed": printed.getvalue().splitlines()}


def train_summary(report: dict) -> dict:
    """The ``train`` line: each part's report without its per-step lists and
    kernel tables (``--out`` keeps them)."""
    drop = ("step_s", "grad_norms", "top_kernels_ms", "printed")
    out = {}
    for name, part in report.items():
        if isinstance(part, dict) and name != "train_reduced":
            part = {k: ({kk: vv for kk, vv in v.items() if kk not in drop}
                        if isinstance(v, dict) else v)
                    for k, v in part.items() if k not in drop}
        out[name] = part
    return out


def drive_train(dev) -> dict:
    """The training path (no kernel of the port is on it: the reference
    trains in plain jnp, the port in plain torch)."""
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    report = {}
    for name, fn in (("train_dense", train_dense), ("train_ssm", train_ssm),
                     ("train_reduced", train_reduced), ("train_converge", train_converge)):
        t0 = time.perf_counter()
        report[name] = fn(dev)
        report[name]["seconds"] = r6(time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return {"expect": {}, "report": report}


# ---------------------------------------------------------------------------
# multi_device: the mesh layer (sharding rules as DTensor placements, the
# sharded MoE, the int8 gradient all-reduce, the Trainer on a mesh with
# elastic restore, the dry run) with several ranks on the one card
# ---------------------------------------------------------------------------
MD_RANKS, MD_MESH = 4, (2, 2)        # processes over gloo on cuda:0, ("data", "model")
MD_MOE_X = {"a2a": (8, 64), "gather": (8, 1)}  # (batch, seq): a2a with tp_split 2, and gather
MD_MOE_REF_SHARE = 0.999            # a2a against md_moe_reference (the dense layer's expert outputs
#   over the routes a plain per-expert count keeps): share of y within 5e-2 relative, the rule of
#   tests/test_distributed.py held at 0.999, since capacity's drops are in the reference
MD_MOE_GATHER_TOL = 3e-2             # gather against dense, and a2a against md_moe_reference: of
#   the largest |y| (bf16)
MD_K5_PER_CALL = 3                   # the expert FFN's gate, up and down products: one launch each
MD_TRAIN = {"layers": 2, "batch": 4, "seq": 512, "steps": 3}  # granite-3-8b, full width, 40 → 2
MD_FSDP = True                       # the TP rules with fsdp: 4 ranks' AdamW state (11.2 GB whole)
#   fits the one card only sharded over "data" as well, on the (4, 1) mesh too
MD_COMPRESS = (64, 4096, 1024)       # dp_value_and_grad: rows, d_in, d_out
MD_COMPRESS_REL = 0.02               # compressed against exact (the reference's test)
MD_CPU_REL = 1e-5                    # card against CPU, the exact mean (f32, TF32 off)
MD_FLIP_SLACK = 1e-3                 # card against CPU, the compressed mean: one rank's payload
#   one step apart (the largest rank's scale / n), times 1 + this for the f32 dequantized sum
MD_NCCL_ARCH = GRANITE               # (d) the one-rank NCCL world: its reduced config, 2 steps
# (f) the other families' mesh step at full width, each the fewest layers that hold every block
# kind it has, 2 steps against one device: deepseek one dense MLA block and the MTP head (no MoE
# layer: (a) drives the expert path), Adafactor as its config pins; zamba2 one Mamba2 layer
# after the shared block's one application; whisper whole
MD_FAMILIES = {
    "deepseek-v3-671b": {"layers": {"num_layers": 1, "first_k_dense": 1}, "batch": 2, "seq": 512},
    "mamba2-780m": {"layers": {"num_layers": 2}, "batch": 4, "seq": 512},
    "zamba2-7b": {"layers": {"num_layers": 1}, "batch": 4, "seq": 512},
    "whisper-tiny": {"layers": {}, "batch": 4, "seq": 448},
}
MD_FAMILY_STEPS = 2
# (f)'s decode steps, ``md_decode_config``'s cuts: each config in f32, held tightly to one device
# (bf16 scores of whisper's sharp cross-attention move its logits by 0.34 on one device alone),
# and granite in bf16, the step whose peak ``traced_peaks`` holds
MD_DECODE_RUNS = {**{arch: (arch, torch.float32) for arch in (GRANITE, *MD_FAMILIES)},
                  f"{GRANITE} bf16": (GRANITE, torch.bfloat16)}
MD_WORLD_TIMEOUT_S = 900
MD_DRYRUN_TIMEOUT_S = 300            # (e) the dry run's processes, waited for after (a)-(d)
MD_DRYRUN_CELLS = tuple((arch, shape) for shape in ("train_4k", "decode_32k")
                        for arch in (GRANITE, "deepseek-v3-671b"))  # (e) the CLI on 16 x 16
PEAK_RATIO = (0.8, 1.25)             # (e) a step's traced peak over the card's
# (f) one mesh decode step a config (granite-3-8b at MD_TRAIN's layers, then MD_FAMILIES'): rows,
# the cache's positions (256 a "model" rank), the position written (in the first rank's slice:
# the second holds only masked rows)
MD_DECODE = {"batch": 4, "capacity": 512, "pos": 200}
MD_DECODE_SEED = 21
# the mesh's logits against one device's, relative L2: f32 (4.98e-7 to 8.29e-5 on the card, the
# largest granite's first rows: a reduction order that is not one device's, through a softmax
# over 201 random keys); bf16, where each TP sum adds the ranks' bf16 partials and one device
# rounds its product once (0.0057 to 0.0117 for granite on the card); a wrong head, slice or
# mask gives O(1)
MD_DECODE_REL = {torch.float32: 1e-3, torch.bfloat16: 0.1}


def sent(summary: dict) -> dict:
    """A ``CollectiveStats.summary()`` without its count of staged
    collectives: what was sent, as the analytic count gives it."""
    return {k: v for k, v in summary.items() if k != "staged"}


def md_log(rank: int, msg: str) -> None:
    """Rank 0's progress on stderr, with the time and the host's available
    memory: where a long or failed run went."""
    if rank == 0:
        avail = next((ln.split()[1] for ln in open("/proc/meminfo")
                      if ln.startswith("MemAvailable")), "?")
        print(f"multi_device rank 0 {time.strftime('%H:%M:%S')} {msg} (host MemAvailable "
              f"{avail} kB)", file=sys.stderr, flush=True)


def md_config():
    return dataclasses.replace(get_config(GRANITE), num_layers=MD_TRAIN["layers"])


def local_bytes(tree) -> int:
    """Device bytes of a tree of tensors, a DTensor by its local shard."""
    return sum(t.numel() * t.element_size() for t in (
        x.to_local() if hasattr(x, "to_local") else x for x in tree_tensors(tree)))


def step_peak(dev, step, state, inputs=()) -> tuple:
    """(``step()``, the card's peak over that one call, its statistics
    reset before it: ``max_memory_allocated``, and the bytes the step holds
    at that peak, the peak less what the process held beside ``state`` and
    ``inputs`` when it started: what a trace of the step counts, the
    state, the inputs and what the step makes)."""
    torch.cuda.synchronize(dev)
    beside = torch.cuda.memory_allocated(dev) - local_bytes(state) - local_bytes(inputs)
    torch.cuda.reset_peak_memory_stats(dev)
    out = step()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return out, {"peak_bytes": peak, "held_beside_bytes": beside, "step_bytes": peak - beside}


def traced_steps() -> dict:
    """{name: (config, mesh shape or None, batch, seq, fsdp, shape)}: each
    train step this script measures a peak of, as it runs it, and (f)'s
    granite decode step (``seq`` its cache's capacity)."""
    mesh = rules_mod.MeshShape(dict(zip(("data", "model"), MD_MESH)))
    steps = {"train": (dataclasses.replace(get_config(GRANITE), num_layers=TRAIN_LAYERS), None,
                       TRAIN_BATCH, TRAIN_SEQ, False, "train_4k"),
             "multi_device/train": (md_config(), mesh, MD_TRAIN["batch"], MD_TRAIN["seq"],
                                    MD_FSDP, "train_4k")}
    for arch, run in MD_FAMILIES.items():
        steps[f"multi_device/{arch}"] = (md_family_data(arch)[0], mesh, run["batch"],
                                         run["seq"], MD_FSDP, "train_4k")
    steps["multi_device/decode"] = (md_config(), mesh, MD_DECODE["batch"],
                                    MD_DECODE["capacity"], MD_FSDP, "decode_32k")
    return steps


def traced_peaks(path: pathlib.Path) -> None:
    """Each ``traced_steps`` step run once on fake tensors on the CPU
    (``launch.dryrun.lower_cell``: rank 0 of a fake world of the mesh's
    size, or one device), its peak live bytes and their largest parts,
    written to ``path`` as JSON.  No card."""
    out = {}
    for name, (cfg, mesh, batch, seq, fsdp, shape) in traced_steps().items():
        got, _ = dryrun_mod.lower_cell(cfg, shape, mesh, fsdp=fsdp, batch=batch, seq=seq)
        top = sorted(got.peak_by.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {"peak_bytes": got.peak_bytes, "trace_s": r6(got.seconds),
                     "largest_at_peak": dict(top)}
    path.write_text(json.dumps(out))


def peak_report(traced: dict, measured: dict) -> dict:
    """Each traced step's peak beside the card's (``step_peak``'s step
    bytes, one a rank on the mesh), their ratio held to ``PEAK_RATIO``."""
    out = {}
    for name, t in traced.items():
        if name not in measured:
            continue
        got = measured[name] if isinstance(measured[name], list) else [measured[name]]
        ratios = [t["peak_bytes"] / m["step_bytes"] for m in got]
        out[name] = {"traced_gb": r6(t["peak_bytes"] / 1e9),
                     "measured_gb": [r6(m["step_bytes"] / 1e9) for m in got],
                     "max_memory_allocated_gb": [r6(m["peak_bytes"] / 1e9) for m in got],
                     "held_beside_gb": [r6(m["held_beside_bytes"] / 1e9) for m in got],
                     "traced_over_measured": [r6(r) for r in ratios], "trace_s": t["trace_s"],
                     "traced_largest_at_peak": t["largest_at_peak"]}
        if not all(PEAK_RATIO[0] <= r <= PEAK_RATIO[1] for r in ratios):
            fail(f"traced peaks: {name}'s traced / measured {ratios} outside {PEAK_RATIO}")
    return out


def md_data():
    cfg = md_config()
    return cfg, data_mod.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=MD_TRAIN["seq"],
                                     global_batch=MD_TRAIN["batch"], seed=0)


def md_moe(rank: int, mesh, dev) -> dict:
    """One granite-moe-3b-a800m MoE layer at full width with int8 experts on
    the (2, 2) mesh, in both sharded modes; rank 0 holds each against the
    whole layer's dense path on its own."""
    cfg = get_config(MOE)
    gen = torch.Generator(device=dev).manual_seed(11)
    params = init_params(moe_mod.moe_defs(cfg), gen, dev)  # the same draws on every rank
    for k in ("wg", "wu", "wd"):
        params[k] = quantize_weight(params[k], lead=1, n_contract=1)
    out = {}
    for mode, (b, s) in MD_MOE_X.items():
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
        spec = rules_mod.batch_spec(b, mesh)
        xs = layout_mod.block_of(x, mesh, spec)
        ep_axes, got_mode, tp_split = moe_mod.sharded_plan(cfg, mesh, xs.shape[0], s)
        if got_mode != mode:
            fail(f"multi_device: {b} x {s} tokens took the {got_mode} mode, not {mode}")
        e_spec = moe_mod._e_spec(ep_axes)
        local = dict(params)
        for k in ("wg", "wu", "wd"):
            local[k] = QuantTensor(layout_mod.block_of(params[k].q, mesh, e_spec).contiguous(),
                                   layout_mod.block_of(params[k].scale, mesh, e_spec).contiguous())
        torch.cuda.synchronize(dev)
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        with rules_mod.activate_mesh(mesh), collectives_mod.recording() as rec:
            y, aux = moe_mod.moe_apply(local, xs, cfg)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = runtime.launch_counts().get("int8_matmul", 0)
        want = moe_mod.moe_collectives(cfg, mesh, xs.shape[0], s, cfg.dtype).summary()
        if sent(rec.summary()) != want:
            fail(f"multi_device moe {mode}: recorded {rec.summary()}, analytic {want}")
        y = layout_mod.full(y, mesh, spec + (None,))
        row = {"tokens": [b, s], "tp_split": tp_split, "ep_axes": list(ep_axes),
               "experts_a_rank": local["wg"].q.shape[0], "k5_launches": launches,
               "ms_first_call": r6(ms), "collectives": rec.summary()}
        if rank == 0:
            y_dense, aux_dense = moe_mod.moe_apply(params, x, cfg)
            yd, yg = y_dense.float(), y.float()
            near = lambda a, b: (a - b).abs() / (b.abs() + 1e-3) < 5e-2  # noqa: E731
            if mode == "a2a":
                if tp_split != 2:
                    fail(f"multi_device moe a2a: tp_split {tp_split}, not 2")
                y_ref, dropped = md_moe_reference(params, x, cfg, MD_MESH[0], tp_split)
                whole = dropped == 0
                share = float(near(yg, y_ref).float().mean())
                err = float((yg - y_ref).abs().max() / y_ref.abs().max())
                row["against_the_reference"] = {
                    "share_within_5e-2": r6(share), "max_err_of_max": r6(err),
                    "share_within_5e-2_of_tokens_with_a_dropped_route": r6(float(
                        near(yg, y_ref)[~whole].float().mean()))}
                row["tokens_with_a_dropped_route"] = r6(float((~whole).float().mean()))
                row["routes_dropped"] = int(dropped.sum())
                row["against_dense"] = {  # capacity's drops make these differ; not a check
                    "share_within_5e-2": r6(float(near(yg, yd).float().mean())),
                    "share_within_5e-2_of_tokens_kept_whole": r6(float(
                        near(yg, yd)[whole].float().mean()))}
                if share < MD_MOE_REF_SHARE or err > MD_MOE_GATHER_TOL:
                    fail(f"multi_device moe a2a: y against the reference: {share} of the elements "
                         f"within 5e-2, {err} of the largest |y|")
            else:
                err = float((yg - yd).abs().max() / yd.abs().max())
                row["max_err_of_max"] = r6(err)
                if err > MD_MOE_GATHER_TOL:
                    fail(f"multi_device moe gather: {err} of the largest |y| from dense")
            row["aux"], row["aux_dense"] = r6(float(aux)), r6(float(aux_dense))
            if not math.isfinite(float(aux)):
                fail("multi_device moe: a non-finite aux loss")
        out[mode] = row
    return out


def md_moe_reference(params, x, cfg, n_data: int, tp_split: int):
    """The a2a mode's y for the whole x (B, S, D), written plainly from the
    dense layer's expert outputs: the router's top-k (``torch.topk``), then
    for each rank's group of tokens (its "data" slice of the batch, cut in
    ``tp_split`` along its flattened tokens: consecutive groups of t tokens)
    a running count per expert over the group's routes, token by token in
    top-k order; a route past the expert's capacity ceil(t·k/E·cf) is
    dropped.  Returns y (f32: the kept routes' gate-weighted expert outputs
    summed) and each token's number of dropped routes (B, S)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    logits = xf.float() @ params["router"].float()
    logits[:, m.num_experts:] = -math.inf  # the padding experts
    w, ids = torch.topk(torch.softmax(logits, dim=-1), m.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    ep = logits.shape[1]
    h = moe_mod._expert_ffn(params["wg"], params["wu"], params["wd"],
                            xf[None].expand(ep, b * s, d), cfg)  # (E, T, D): the dense layer's
    t = b // n_data * s // tp_split
    capacity = max(1, math.ceil(t * m.top_k / m.num_experts * m.capacity_factor))
    keep = torch.ones((b * s, m.top_k), dtype=torch.bool)
    routes = ids.cpu().tolist()
    for g in range(0, b * s, t):
        count: dict = {}
        for tok in range(g, g + t):
            for j, e in enumerate(routes[tok]):
                count[e] = count.get(e, 0) + 1
                keep[tok, j] = count[e] <= capacity
    keep = keep.to(x.device)
    rows = torch.arange(b * s, device=x.device)
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for j in range(m.top_k):
        y += torch.where(keep[:, j, None], w[:, j, None] * h[ids[:, j], rows].float(), 0.0)
    return y.reshape(b, s, d), (~keep).sum(1).reshape(b, s)


def md_family_data(arch: str):
    """(config, dataset) of an ``MD_FAMILIES`` run: full width, its layers."""
    run = MD_FAMILIES[arch]
    cfg = dataclasses.replace(get_config(arch), **run["layers"])
    return cfg, data_mod.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=run["seq"],
                                     global_batch=run["batch"], seed=0)


def md_family_steps(arch: str, name: str, dev, mesh=None):
    """``MD_FAMILY_STEPS`` steps of ``arch``'s ``MD_FAMILIES`` Trainer on
    ``dev`` or on every rank of ``mesh`` (built under the TP rules with
    fsdp), each step's collectives recorded: (losses, gradient norms, step
    s, the records, the Trainer's layout, this process's peak bytes, the
    last step's ``step_peak``)."""
    cfg, ds = md_family_data(arch)
    tc = trainer_config(name, MD_FAMILY_STEPS, checkpoint_every=MD_FAMILY_STEPS + 1, keep=1,
                        peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    torch.cuda.reset_peak_memory_stats(dev)
    if mesh is None:
        tr = FanInTrainer(cfg, ds, tc, device=dev)
    else:
        with rules_mod.activate_mesh(mesh, rules_mod.tensor_parallel_rules(fsdp=MD_FSDP)):
            tr = FanInTrainer(cfg, ds, tc, mesh=mesh)
    recs, step_fn = [], tr.step_fn

    def recorded(*a):
        with collectives_mod.recording() as rec:
            out = step_fn(*a)
        recs.append(rec.summary())
        return out

    tr.step_fn = recorded
    for step in range(MD_FAMILY_STEPS - 1):  # no final checkpoint to write
        tr._do_step(step)
    peak = torch.cuda.max_memory_allocated(dev)
    _, last = step_peak(dev, lambda: tr._do_step(MD_FAMILY_STEPS - 1), tr._state())
    rows, lay = tr.metrics_log, tr.layout
    out = ([r["loss"] for r in rows], [r["grad_norm"] for r in rows],
           [r6(r["time_s"]) for r in rows], recs, lay, max(peak, last["peak_bytes"]), last)
    del tr, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR / name, ignore_errors=True)
    return out


def md_family(rank: int, arch: str, mesh22, dev) -> dict:
    """``arch``'s mesh step on the (2, 2) mesh: each layer on the rank's
    "model" shard; every step's collectives equal to ``step_collectives``."""
    losses, norms, step_s, recs, lay, peak, last = md_family_steps(arch, f"mesh_{arch}", dev,
                                                                   mesh22)
    cfg, ds = md_family_data(arch)
    analytic = train_loop_mod.step_collectives(
        cfg, mesh22, rules_mod.tensor_parallel_rules(fsdp=MD_FSDP), ds.global_batch,
        ds.seq_len).summary()
    if any(sent(r) != analytic for r in recs):
        fail(f"multi_device {arch}: recorded {recs[0]}, analytic {analytic}")
    tp_leaves = ["/".join(map(str, p)) for p, c in zip(lay.paths, lay.compute_specs)
                 if "model" in c and not train_loop_mod._is_expert(p)]
    if not tp_leaves:
        fail(f"multi_device {arch}: no leaf computes on its \"model\" block")
    md_log(rank, f"{arch}: {MD_FAMILY_STEPS} steps done")
    return {"losses": losses, "grad_norms": norms, "step_s": step_s,
            "peak_memory_gb": r6(peak / 1e9), "step_peak": last,
            "tp_leaves_of": [len(tp_leaves), len(lay.paths)],
            "tp_leaves": tp_leaves, "collectives_a_step": {"recorded": recs[0],
                                                           "analytic": analytic}}


def md_family_report(arch: str, runs: list, one: dict) -> dict:
    """An ``MD_FAMILIES`` run's entry of the line: every rank's losses and
    gradient norms the same, within ``TRAIN_REPLAY_TOL`` of one device's
    (the gradient norm as well as the loss: a gradient summed or divided
    wrongly on the mesh shows in the norm alone), and finite."""
    mesh = runs[0]
    errs = [abs(a - b) / abs(b) for a, b in zip(mesh["losses"] + mesh["grad_norms"],
                                                one["losses"] + one["grad_norms"])]
    if (len(mesh["losses"]) != MD_FAMILY_STEPS
            or not all(math.isfinite(v) for v in mesh["losses"] + mesh["grad_norms"])
            or max(errs) > TRAIN_REPLAY_TOL):
        fail(f"multi_device {arch}: mesh losses {mesh['losses']} and gradient norms "
             f"{mesh['grad_norms']}, one device {one['losses']} {one['grad_norms']}")
    if any(t["losses"] != mesh["losses"] or t["grad_norms"] != mesh["grad_norms"] for t in runs):
        fail(f"multi_device {arch}: the ranks logged different losses or gradient norms")
    coll = mesh["collectives_a_step"]
    return {**MD_FAMILIES[arch], "steps": MD_FAMILY_STEPS,
            "losses_mesh": [r6(v) for v in mesh["losses"]],
            "losses_one_device": [r6(v) for v in one["losses"]],
            "grad_norms_mesh": [r6(v) for v in mesh["grad_norms"]],
            "grad_norms_one_device": [r6(v) for v in one["grad_norms"]],
            "rel_err_losses_then_norms": [r6(e) for e in errs],
            "step_s_by_rank": [t["step_s"] for t in runs], "step_s_one_device": one["step_s"],
            "peak_memory_gb_by_rank": [t["peak_memory_gb"] for t in runs],
            "peak_memory_gb_one_device": one["peak_memory_gb"],
            "tp_leaves_of": mesh["tp_leaves_of"], "tp_leaves": mesh["tp_leaves"],
            "bytes_a_rank_a_step_by_kind": {
                k: {side: coll[side]["by_op"][k]["operand_bytes"]
                    for side in ("recorded", "analytic")} for k in coll["analytic"]["by_op"]}}


def md_decode_config(name: str) -> ArchConfig:
    """(f)'s decode config ``name`` of ``MD_DECODE_RUNS``: granite-3-8b at
    ``MD_TRAIN``'s layers, the others as ``MD_FAMILIES`` cuts them, in the
    run's dtype."""
    arch, dtype = MD_DECODE_RUNS[name]
    cfg = md_config() if arch == GRANITE else md_family_data(arch)[0]
    return dataclasses.replace(cfg, dtype=dtype)


def md_decode_inputs(cfg: ArchConfig, dev) -> tuple:
    """(the whole cache of ``MD_DECODE``'s rows and positions, random,
    the rows' tokens), the same draws in every process."""
    gen = torch.Generator(device=dev).manual_seed(MD_DECODE_SEED)
    b, cap = MD_DECODE["batch"], MD_DECODE["capacity"]
    cache = {k: torch.randn(d.shape, generator=gen, device=dev).to(d.dtype)
             for k, d in cache_defs(cfg, batch=b, max_len=cap).items()}
    token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev,
                          dtype=torch.int32)
    return cache, token


def md_decode_params(cfg: ArchConfig, dev, keep=None):
    """``init_model``'s draw (whole leaves, or the blocks ``keep`` cuts), in
    f32 for an f32 config (``init_model`` draws bf16 leaves)."""
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(MD_DECODE_SEED + 1), dev,
                        keep=keep)
    if cfg.dtype == torch.float32:
        params = tree_map(lambda t: t.float(), params)
    return params


def md_decode_one(dev) -> dict:
    """{arch: the one-device ``decode_step``'s logits (B, V) f32 on the
    host}: the references of ``md_decode``, run in the parent."""
    out = {}
    for name in MD_DECODE_RUNS:
        cfg = md_decode_config(name)
        params = md_decode_params(cfg, dev)
        cache, token = md_decode_inputs(cfg, dev)
        pos = torch.tensor(MD_DECODE["pos"], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            logits, _ = model_mod.decode_step(params, cache, token, pos, cfg)
        out[name] = logits.cpu()
        del params, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    return out


def md_decode(rank: int, mesh22, dev) -> dict:
    """(f)'s mesh decode steps on the (2, 2) mesh, each ``MD_DECODE_RUNS``
    config: the rank's blocks of the params (drawn as
    ``Trainer`` draws them on a mesh, under the TP rules with fsdp),
    ``dryrun.make_mesh_decode`` on the rank's rows and its block of the
    cache (the positions split over "model", ``dryrun.decode_cache_specs``),
    at ``MD_DECODE["pos"]``: the logits (the rank's rows, on the host), the
    step's collectives against ``forward_collectives(decode=True)``, and its
    ``step_peak``."""
    rules = rules_mod.tensor_parallel_rules(fsdp=MD_FSDP)
    b, cap = MD_DECODE["batch"], MD_DECODE["capacity"]
    out = {}
    for name in MD_DECODE_RUNS:
        cfg = md_decode_config(name)
        lay = train_loop_mod.MeshLayout(cfg, mesh22, rules, b, 1)
        blocks = md_decode_params(cfg, dev, keep=lay.keep())
        params = tree_unflatten(blocks, lay.wrap(tree_flatten(blocks), lay.param_specs))
        whole, token = md_decode_inputs(cfg, dev)
        specs = dryrun_mod.decode_cache_specs(cfg, mesh22, rules, b, cap)
        cache = {k: layout_mod.block_of(whole[k], mesh22, sp).clone()
                 for k, (_, sp) in specs.items()}
        batch = {"token": layout_mod.block_of(token, mesh22, lay.batch_spec).clone(),
                 "pos": torch.tensor(MD_DECODE["pos"], dtype=torch.int32, device=dev)}
        del whole, token, blocks
        run = dryrun_mod.make_mesh_decode(cfg, lay, cap)

        def step():
            with collectives_mod.recording() as rec:
                logits, _ = run(params, cache, batch)
            return logits, rec.summary()

        t0 = time.perf_counter()
        (logits, rec), peak = step_peak(dev, step, (params, cache), batch)
        step_s = time.perf_counter() - t0
        analytic = dryrun_mod.forward_collectives(cfg, mesh22, rules, b, cap, decode=True,
                                                  dtype=cfg.dtype).summary()
        if sent(rec) != analytic:
            fail(f"multi_device decode {name}: recorded {rec}, analytic {analytic}")
        out[name] = {"logits": logits.float().cpu(), "step_s": r6(step_s), "step_peak": peak,
                     "cache_split": sorted(k for k, (_, sp) in specs.items() if "model" in sp),
                     "collectives": {"recorded": rec, "analytic": analytic}}
        del params, cache, batch, logits, run
        gc.collect()
        torch.cuda.empty_cache()
    md_log(rank, "decode: the mesh decode steps done")
    return out


def md_decode_report(ranks: list, one: dict) -> dict:
    """(f)'s decode entry: each rank's logits over the vocabulary (the
    padding's -1e30 columns aside) within ``MD_DECODE_REL`` of its rows of
    one device's, finite, every "model" rank of a row the same logits, and
    the greedy tokens' agreement."""
    out = {**MD_DECODE}
    for name, want in one.items():
        rels, agree = [], []
        cfg = md_decode_config(name)
        vocab, bound = cfg.vocab_size, MD_DECODE_REL[cfg.dtype]
        for r in ranks:
            got = r["decode"][name]["logits"][:, :vocab]
            d = r["coordinate"][0]
            rows = want[d * got.shape[0]:(d + 1) * got.shape[0], :vocab]
            rels.append(float((got - rows).norm() / rows.norm()))
            agree.append(float((got.argmax(-1) == rows.argmax(-1)).float().mean()))
            if not bool(torch.isfinite(got).all()):
                fail(f"multi_device decode {name}: non-finite logits on rank {r['rank']}")
        for a, b_ in zip(ranks, ranks[1:]):
            if a["coordinate"][0] == b_["coordinate"][0] and not torch.equal(
                    a["decode"][name]["logits"], b_["decode"][name]["logits"]):
                fail(f"multi_device decode {name}: the \"model\" ranks of a row differ")
        if not max(rels) <= bound:  # a NaN fails too
            fail(f"multi_device decode {name}: the mesh's logits {rels} from one device's, "
                 f"over {bound}")
        first = ranks[0]["decode"][name]
        coll = first["collectives"]
        out[name] = {"rel_err_by_rank": [r6(v) for v in rels], "bound": bound,
                     "argmax_agreement_by_rank": [r6(v) for v in agree],
                     "cache_split": first["cache_split"],
                     "step_s_by_rank": [r["decode"][name]["step_s"] for r in ranks],
                     "step_peak_gb_by_rank": [r6(r["decode"][name]["step_peak"]["peak_bytes"]
                                                 / 1e9) for r in ranks],
                     "bytes_a_rank_by_kind": {
                         k: {side: coll[side]["by_op"][k]["operand_bytes"]
                             for side in ("recorded", "analytic")}
                         for k in coll["analytic"]["by_op"]}}
    return out


def md_compress(rank: int, dev) -> dict:
    """dp_value_and_grad of the reference's test loss on (4, 1) meshes of the
    card and of the CPU: compressed against exact, the card against the CPU."""
    n, d_in, d_out = MD_COMPRESS
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((d_in, d_out), generator=gen) / math.sqrt(d_in)
    x, y = torch.randn((n, d_in), generator=gen), torch.randn((n, d_out), generator=gen)

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    got = {}
    for kind in ("cuda", "cpu"):
        mesh = init_device_mesh(kind, (MD_RANKS, 1), mesh_dim_names=("data", "model"))
        target = dev if kind == "cuda" else torch.device("cpu")
        spec = rules_mod.batch_spec(n, mesh)
        batch = {k: layout_mod.block_of(v, mesh, spec).to(target) for k, v in (("x", x), ("y", y))}
        for name, compressed in (("exact", False), ("compressed", True)):
            with collectives_mod.recording() as rec:
                l, g = grad_compress_mod.dp_value_and_grad(loss, mesh, compressed=compressed)(
                    {"w": w.to(target)}, batch)
            got[kind, name] = (float(l), g["w"].cpu(), rec.summary())
    # one step of one rank's payload (the largest rank's scale / n) with f32 slack: the card's
    # and the CPU's gradients differ at f32 noise, which can move an entry of a rank's payload
    # across a rounding boundary; a wrong rounding mode moves many entries by more
    steps = [float((2.0 * xb.T @ (xb @ w - yb) / (xb.shape[0] * d_out)).abs().max()) / 127.0
             / MD_RANKS for xb, yb in zip(x.chunk(MD_RANKS), y.chunk(MD_RANKS))]
    step = max(steps) * (1 + MD_FLIP_SLACK)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    apart = (got["cuda", "compressed"][1] - got["cpu", "compressed"][1]).abs()
    out = {"rows": n, "shape": [d_in, d_out],
           "compressed_vs_exact_rel": r6(rel(got["cuda", "compressed"][1], got["cuda", "exact"][1])),
           "card_vs_cpu_exact_rel": r6(rel(got["cuda", "exact"][1], got["cpu", "exact"][1])),
           "card_vs_cpu_compressed_max_abs": r6(float(apart.max())),
           "card_vs_cpu_compressed_entries_flipped": int((apart > min(steps) / 2).sum()),
           "one_step_of_the_largest_rank": r6(step),
           "collectives": {"exact": got["cuda", "exact"][2],
                           "compressed": got["cuda", "compressed"][2]}}
    if out["compressed_vs_exact_rel"] >= MD_COMPRESS_REL:
        fail(f"multi_device grad_compress: {out['compressed_vs_exact_rel']} from the exact mean")
    if out["card_vs_cpu_exact_rel"] > MD_CPU_REL:
        fail(f"multi_device grad_compress: the card's exact mean {out['card_vs_cpu_exact_rel']} "
             "from the CPU's")
    if float(apart.max()) > step:
        fail(f"multi_device grad_compress: the card's compressed mean {float(apart.max())} from "
             f"the CPU's, over one step of the largest rank {step}")
    return out


def md_train(rank: int, mesh22, dev) -> dict:
    """granite-3-8b at full width, 2 layers, AdamW, 4 x 512 tokens on the
    (2, 2) mesh for 3 steps, every step recorded; its final checkpoint (saved
    from the mesh) restored onto a (4, 1) mesh for the next step."""
    cfg, ds = md_data()
    steps = MD_TRAIN["steps"]
    tc = trainer_config("mesh", steps, checkpoint_every=steps + 1, keep=1,
                        peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    rules = rules_mod.tensor_parallel_rules(fsdp=MD_FSDP)
    torch.cuda.reset_peak_memory_stats(dev)
    with rules_mod.activate_mesh(mesh22, rules):  # the Trainer lays its state out by these rules
        tr = FanInTrainer(cfg, ds, tc, mesh=mesh22)  # keeps 2.8 GB, one whole leaf at a time
    built_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # the leaves the step computes on the rank's "model" block (tensor-parallel compute)
    tp_leaves = sum("model" in c for c in tr.layout.compute_specs)
    if not tp_leaves:
        fail("multi_device train: no leaf computes on its \"model\" block")
    md_log(rank, "train: the (2, 2) Trainers built")
    recs, step_fn = [], tr.step_fn

    def recorded(*a):
        with collectives_mod.recording() as rec:
            out = step_fn(*a)
        recs.append(rec.summary())
        md_log(rank, f"train: step {a[-1]} done")
        return out

    tr.step_fn = recorded
    stats = tr.run()
    md_log(rank, "train: run and its checkpoint done")
    rows = stats["metrics"]
    peak = torch.cuda.max_memory_allocated(dev)
    batch = tr.batch(steps)
    m, last = step_peak(dev, lambda: step_fn(tr.params, tr.opt_state, batch, steps)[2],
                        tr._state(), batch)
    next_22 = (float(m["loss"]), float(m["grad_norm"]))
    peak = max(peak, last["peak_bytes"])
    analytic = train_loop_mod.step_collectives(cfg, mesh22, rules, ds.global_batch,
                                               ds.seq_len).summary()
    if any(sent(r) != analytic for r in recs):
        fail(f"multi_device train: recorded {recs[0]}, analytic {analytic}")
    del tr, step_fn, m, batch
    gc.collect()
    torch.cuda.empty_cache()

    mesh41 = init_device_mesh("cuda", (MD_RANKS, 1), mesh_dim_names=("data", "model"))
    tc41 = dataclasses.replace(tc, num_steps=steps + 1)
    with rules_mod.activate_mesh(mesh41, rules):
        tr = FanInTrainer(cfg, ds, tc41, mesh=mesh41)
    md_log(rank, "train: the (4, 1) Trainers built")
    t0 = time.perf_counter()
    start = tr._restore()
    restore_s = time.perf_counter() - t0
    md_log(rank, "train: restored onto (4, 1)")
    m = tr.step_fn(tr.params, tr.opt_state, tr.batch(start), start)[2]
    md_log(rank, "train: the (4, 1) step done")
    out = {"losses": [r["loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
           "step_s": [r6(r["time_s"]) for r in rows], "restarts": stats["restarts"],
           "next_2x2": next_22, "restored_4x1": {
               "start": start, "next": (float(m["loss"]), float(m["grad_norm"])),
               "restore_s": r6(restore_s)},
           "peak_memory_gb": r6(peak / 1e9), "peak_after_build_gb": r6(built_gb),
           "step_peak": last,
           "tp_leaves": tp_leaves, "leaves": len(tr.layout.compute_specs),
           "collectives_a_step": {"recorded": recs[0], "analytic": analytic}}
    del tr, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def md_rank(rank: int, world: int, part: str) -> dict:
    """One rank of a multi_device world: ``part`` "mesh" (4 gloo ranks: the
    MoE, the int8 all-reduce, the Trainer) or "nccl" (one NCCL rank)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    runtime.load_kernels()
    if part == "nccl":
        return md_nccl(dev)
    mesh22 = init_device_mesh("cuda", MD_MESH, mesh_dim_names=("data", "model"))
    out = {"rank": rank, "coordinate": list(mesh22.get_coordinate()), "seconds": {}}
    families = [(arch, lambda a=arch: md_family(rank, a, mesh22, dev)) for arch in MD_FAMILIES]
    for name, fn in [("moe", lambda: md_moe(rank, mesh22, dev)),
                     ("grad_compress", lambda: md_compress(rank, dev)),
                     ("train", lambda: md_train(rank, mesh22, dev))] + families + [
                        ("decode", lambda: md_decode(rank, mesh22, dev))]:
        md_log(rank, f"{name} starts")
        t0 = time.perf_counter()
        out[name] = fn()
        out["seconds"][name] = r6(time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def md_nccl(dev) -> dict:
    """A world of one NCCL rank: one all-reduce on the NCCL group, then the
    Trainer of ``MD_NCCL_ARCH``'s reduced config on a (1, 1) mesh of the
    card for 2 steps against ``mesh=None``,
    bit for bit (deterministic kernels in this process)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    one = torch.ones((), device=dev)
    torch.distributed.all_reduce(one)
    if float(one) != 1.0:
        fail("multi_device nccl: the all-reduce of one rank changed its value")
    cfg = get_reduced_config(MD_NCCL_ARCH)  # the backend's path, not the width: (b) has that
    ds = data_mod.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=0)
    got = {}
    for name, mesh in (("mesh_none", None), ("mesh_1x1", "cuda")):
        tc = trainer_config(f"nccl_{name}", 2, checkpoint_every=4, keep=1, peak_lr=TRAIN_LR,
                            warmup_steps=TRAIN_WARMUP)
        m = None if mesh is None else init_device_mesh(mesh, (1, 1),
                                                       mesh_dim_names=("data", "model"))
        tr = FanInTrainer(cfg, ds, tc, device=None if m else dev, mesh=m)
        for step in range(2):  # no final checkpoint to write
            tr._do_step(step)
        rows = tr.metrics_log
        state = tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t, tr._state())
        got[name] = ([r["loss"] for r in rows], state_digest(state))
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(TRAIN_DIR / f"nccl_{name}", ignore_errors=True)
    if got["mesh_none"] != got["mesh_1x1"]:
        fail(f"multi_device nccl: the (1, 1) mesh's losses or state differ from mesh=None: "
             f"{got['mesh_none'][0]} {got['mesh_1x1'][0]}")
    return {"backend": torch.distributed.get_backend(), "arch": f"{MD_NCCL_ARCH} (reduced)",
            "losses": got["mesh_none"][0], "state_leaves_bitwise_equal": len(got["mesh_none"][1])}


def md_world(part: str, world: int, backend: str) -> list:
    TRAIN_DIR.parent.mkdir(parents=True, exist_ok=True)
    store = TRAIN_DIR.parent / f"store_{part}_{time.time_ns()}"
    # the ranks share the card: the allocator grows its segments in place rather than caching
    # blocks of the forward's sizes beside the optimizer's (deepseek's f32 transients of 3.7 GB)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        return world_mod.run_world(md_rank, world, backend=backend, init_file=str(store),
                                   device_type="cuda", args=(part,),
                                   timeout_s=MD_WORLD_TIMEOUT_S)
    finally:
        store.unlink(missing_ok=True)
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def drive_multi_device(dev, train_peak: dict | None = None) -> dict:
    """The multi-device layer on the one card.  The ranks are processes over
    gloo with CUDA tensors (NCCL refuses two ranks on one card); gloo's
    collectives of CUDA tensors are staged through host memory at the
    port's choke point, and the line names them.  (a) the MoE, (b) the
    Trainer, (c) the int8 all-reduce, (f) the other families' Trainers in a
    world of 4; (d) a world of one NCCL rank; (e) the traced dry run, the
    CLI a process a cell and the traced peaks a process, started first (they
    use no card, so they run beside (a)-(d)); ``train_peak``, where given,
    is the ``train`` step's ``step_peak``, held to its trace beside (b)'s
    and (f)'s.  The one-device Trainers of (b) and (f) run here before the
    world, and the mesh's checkpoint is restored here after it."""
    mode = smi_query("compute_mode")
    if mode not in ("Default", "[N/A]"):
        fail(f"multi_device: the card's compute mode {mode!r} refuses a second process")
    dry_dir = TRAIN_DIR.parent / "dryrun"
    shutil.rmtree(dry_dir, ignore_errors=True)
    dry_dir.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent / "src")}
    # one process an arch, its cells one after the other: the world of 4 shares the host's cores
    commands = {}
    for arch in dict.fromkeys(a for a, _ in MD_DRYRUN_CELLS):
        runs = [["--arch", arch, "--shape", shape, "--out", str(dry_dir)]
                for a, shape in MD_DRYRUN_CELLS if a == arch]
        commands[arch] = [sys.executable, "-c", "import sys; from repro_torch.launch.dryrun "
                          f"import main; sys.exit(max(main(a) for a in {runs!r}))"]
    commands["traced_peaks"] = [sys.executable, str(pathlib.Path(__file__).resolve()),
                                "--traced-peaks", str(dry_dir / "traced_peaks.json")]
    t_cli = time.perf_counter()  # the phase's start
    procs = {}
    try:
        for name, cmd in commands.items():
            with open(dry_dir / f"{name}.stderr.txt", "w") as err:
                procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err,
                                               env=env)
        return md_drive(dev, mode, procs, t_cli, dry_dir, train_peak)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def md_drive(dev, mode: str, procs: dict, t_cli: float, dry_dir, train_peak) -> dict:
    """``drive_multi_device``'s phases, the dry run's processes ``procs``
    running."""
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg, ds = md_data()
    steps = MD_TRAIN["steps"]
    t_one = time.perf_counter()
    tc = trainer_config("one", steps, checkpoint_every=steps + 1, keep=1,
                        peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    one = FanInTrainer(cfg, ds, tc, device=dev)
    for step in range(steps):  # the mesh's schedule, and no final checkpoint to write
        one._do_step(step)
    m = one.step_fn(one.params, one.opt_state, one.batch(steps), steps)[2]
    one_losses = [r["loss"] for r in one.metrics_log] + [float(m["loss"])]
    one_norms = [r["grad_norm"] for r in one.metrics_log] + [float(m["grad_norm"])]
    one_step_s = [r6(r["time_s"]) for r in one.metrics_log]
    del one, m
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t_one
    t_fam = time.perf_counter()
    one_family = {}
    for arch in MD_FAMILIES:
        losses, norms, step_s, _, _, peak, _ = md_family_steps(arch, f"one_{arch}", dev)
        one_family[arch] = {"losses": losses, "grad_norms": norms, "step_s": step_s,
                            "peak_memory_gb": r6(peak / 1e9)}
        md_log(0, f"parent: the one-device {arch} Trainer done")
    family_one_s = time.perf_counter() - t_fam
    t_dec = time.perf_counter()
    decode_one = md_decode_one(dev)
    decode_one_s = time.perf_counter() - t_dec
    md_log(0, "parent: the one-device decode steps done")
    parent_bytes = torch.cuda.memory_allocated(dev)
    md_log(0, "parent: the one-device Trainer done; spawning the ranks")

    t0 = time.perf_counter()
    ranks = md_world("mesh", MD_RANKS, "gloo")
    world_s = time.perf_counter() - t0
    md_log(0, "parent: the world of 4 joined")
    train = [r["train"] for r in ranks]
    mesh_losses, mesh_norms = train[0]["losses"], train[0]["grad_norms"]
    # the gradient norm as well as the loss: AdamW divides each leaf's gradient by its own
    # running scale, so a gradient summed or divided wrongly on the mesh shows in the norm alone
    errs = [abs(a - b) / abs(b) for a, b in zip(mesh_losses + mesh_norms,
                                                one_losses[:steps] + one_norms[:steps])]
    if len(mesh_losses) != steps or max(errs) > TRAIN_REPLAY_TOL:
        fail(f"multi_device train: mesh losses {mesh_losses} and gradient norms {mesh_norms}, "
             f"one device {one_losses[:steps]} {one_norms[:steps]}")
    if any(t["losses"] != mesh_losses or t["grad_norms"] != mesh_norms for t in train):
        fail("multi_device train: the ranks logged different losses or gradient norms")

    families = {arch: md_family_report(arch, [r[arch] for r in ranks], one_family[arch])
                for arch in MD_FAMILIES}
    decode = md_decode_report(ranks, decode_one)

    # the mesh's final checkpoint restored on one device: the next step
    tc1 = trainer_config("mesh", steps + 1, checkpoint_every=steps + 2, keep=1,
                         peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    t_fresh = time.perf_counter()
    fresh = FanInTrainer(cfg, ds, tc1, device=dev)
    start = fresh._restore()
    m = fresh.step_fn(fresh.params, fresh.opt_state, fresh.batch(start), start)[2]
    restored_one = (float(m["loss"]), float(m["grad_norm"]))
    fresh_s = time.perf_counter() - t_fresh
    del fresh, m
    gc.collect()
    torch.cuda.empty_cache()
    # (loss, gradient norm) of the step after the last
    nexts = {"one_device_run": (one_losses[steps], one_norms[steps]),
             "mesh_2x2": tuple(train[0]["next_2x2"]),
             "restored_4x1": tuple(train[0]["restored_4x1"]["next"]),
             "restored_one_device": restored_one}
    want = nexts["mesh_2x2"]
    if start != steps or any(t["restored_4x1"]["start"] != steps for t in train) or max(
            abs(a - b) / abs(b) for v in nexts.values() for a, b in zip(v, want)
    ) > TRAIN_REPLAY_TOL:
        fail(f"multi_device train: the next step after the restores: {nexts}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    t0 = time.perf_counter()
    md_log(0, "parent: restored on one device; the NCCL world")
    nccl = md_world("nccl", 1, "nccl")[0]
    nccl_s = time.perf_counter() - t0
    md_log(0, "parent: the NCCL world joined")
    deadline = time.monotonic() + MD_DRYRUN_TIMEOUT_S
    for name, proc in procs.items():
        if proc.wait(timeout=max(deadline - time.monotonic(), 1.0)) != 0:
            fail(f"multi_device: the dry run's {name} process returned {proc.returncode}: "
                 f"{(dry_dir / f'{name}.stderr.txt').read_text()[-2000:]}")
    cli_s = time.perf_counter() - t_cli
    dry = {}
    for arch, shape in MD_DRYRUN_CELLS:
        cell = json.loads((dry_dir / f"16x16__{arch}__{shape}.json").read_text())
        coll = cell["collectives"]
        if coll["traced"] != coll["analytic"]:
            fail(f"multi_device: the dry run's {arch} x {shape} step sent {coll['traced']}, "
                 f"counted {coll['analytic']}")
        empty = [k for k in dryrun_mod.TRACED_FIELDS if cell[k] is None]
        if empty:
            fail(f"multi_device: the dry run's {arch} x {shape} cell has null traced fields "
                 f"{empty}")
        dry[f"{arch} x {shape}"] = {"resident_gb_per_dev": cell["resident_gb_per_dev"],
                     "fits_hbm_resident": cell["fits_hbm_resident"],
                     "live_gb_per_dev": cell["live_gb_per_dev"],
                     "fits_hbm_live": cell["fits_hbm_live"], "trace_s": cell["lower_s"],
                     "flops_per_dev": cell["cost_analysis"]["flops_per_dev"],
                     "fit_flops_per_dev": cell["cost_analysis"]["fit"]["flops_per_dev"],
                     "collective_bytes_per_dev": coll["analytic"]["total_bytes"],
                     "traced_equals_analytic": True,
                     "null_fields": sorted(k for k, v in cell.items() if v is None)}
    measured = {"multi_device/train": [r["train"]["step_peak"] for r in ranks]}
    measured.update({f"multi_device/{arch}": [r[arch]["step_peak"] for r in ranks]
                     for arch in MD_FAMILIES})
    measured["multi_device/decode"] = [r["decode"][f"{GRANITE} bf16"]["step_peak"]
                                       for r in ranks]
    if train_peak is not None:
        measured["train"] = train_peak
    peaks = peak_report(json.loads((dry_dir / "traced_peaks.json").read_text()), measured)
    shutil.rmtree(dry_dir, ignore_errors=True)

    moe = {mode: {"rank0": ranks[0]["moe"][mode],
                  "k5_launches_by_rank": [r["moe"][mode]["k5_launches"] for r in ranks]}
           for mode in MD_MOE_X}
    expect_k5 = MD_K5_PER_CALL * len(MD_MOE_X) * MD_RANKS
    k5 = sum(sum(m["k5_launches_by_rank"]) for m in moe.values())
    staged = {}
    for r in ranks:
        for rec in [r["train"]["collectives_a_step"]["recorded"]] + [
                r["moe"][m]["collectives"] for m in MD_MOE_X] + [
                r[arch]["collectives_a_step"]["recorded"] for arch in MD_FAMILIES]:
            for kind, n in rec.get("staged", {}).items():
                staged[kind] = staged.get(kind, 0) + n
    report = {
        "ranks": MD_RANKS, "mesh": list(MD_MESH), "processes": "spawned", "backend": "gloo",
        "compute_mode": mode, "staged_collectives": sorted(staged),
        "coordinates": [r["coordinate"] for r in ranks], "rank0_seconds": ranks[0]["seconds"],
        "parent_bytes_allocated_at_spawn": parent_bytes, "world_s": r6(world_s),
        "one_device_run_s": r6(one_s), "one_device_restore_and_step_s": r6(fresh_s),
        "moe": moe, "k5": {"launches": k5, "expected": expect_k5},
        "train": {"arch": GRANITE, **MD_TRAIN, "losses_mesh": [r6(v) for v in mesh_losses],
                  "losses_one_device": [r6(v) for v in one_losses[:steps]],
                  "grad_norms_mesh": [r6(v) for v in mesh_norms],
                  "grad_norms_one_device": [r6(v) for v in one_norms[:steps]],
                  "rel_err_losses_then_norms": [r6(e) for e in errs],
                  "next_step_loss_and_grad_norm": {
                      k: [r6(x) for x in v] for k, v in nexts.items()},
                  "step_s_rank0": train[0]["step_s"], "step_s_one_device": one_step_s,
                  "step_s_by_rank": [t["step_s"] for t in train],
                  "peak_memory_gb_by_rank": [t["peak_memory_gb"] for t in train],
                  "peak_after_build_gb_by_rank": [t["peak_after_build_gb"] for t in train],
                  "tp_leaves_of": [train[0]["tp_leaves"], train[0]["leaves"]],
                  "bytes_a_rank_a_step_by_kind": {
                      k: {side: train[0]["collectives_a_step"][side]["by_op"][k]["operand_bytes"]
                          for side in ("recorded", "analytic")}
                      for k in train[0]["collectives_a_step"]["analytic"]["by_op"]},
                  "collectives_a_step": train[0]["collectives_a_step"],
                  "restore_4x1_s": train[0]["restored_4x1"]["restore_s"]},
        "families": families, "families_one_device_s": r6(family_one_s),
        "decode": decode, "decode_one_device_s": r6(decode_one_s),
        "grad_compress": ranks[0]["grad_compress"],
        "nccl": {**nccl, "world_s": r6(nccl_s)},
        "dryrun": {"seconds_to_join": r6(cli_s), "cells_16x16": dry},
        "traced_peaks": peaks,
    }
    if k5 != expect_k5:
        fail(f"multi_device: {k5} K5 launches on the sharded MoE, {expect_k5} expected")
    report["phase_s"] = r6(time.perf_counter() - t_cli)
    return {"expect": {}, "report": report, "k5_launches": k5}


# ---------------------------------------------------------------------------
# plan: the step cost model (core/cost_model.py) against this run's own
# measurements, at the shapes the card runs, full width
# ---------------------------------------------------------------------------
PLAN_TRAIN = ("train_4k", {"dp": 128, "tp": 1})  # 256 x 4096 over 128 cards: the train path's 2 x 4096
PLAN_DECODE = ("decode_32k", {"dp": 32, "tp": 1})  # 128 slots at 32768 over 32 cards: 4 a card
PLAN_DECODE_SC = {"max_batch": 4, "max_len": 32768}
PLAN_PROMPT = 16                    # tokens each slot holds before the timed ticks
PLAN_TICKS = 9
PLAN_POS = PLAN_DECODE_SC["max_len"] - 2  # every slot's position in the timed ticks
PLAN_APP = {"name": "card-serve", "goal": "energy_efficiency", "period_s": 2.0,
            "max_latency_s": 1.0}   # quickstart's serving application, on one card


def drive_plan_decode(dev, base) -> dict:
    """The replayed decode tick of serve_dense's int8 weights on a 4 x 32768
    contiguous pool (decode_32k's slots and context a card: 4.3 GB of bf16
    K/V over 8 layers): its unprofiled median, a replay alone by CUDA
    events, one profiled tick.  Decode attention reads the rows through each
    slot's position, so after a short prefill every slot's position is moved
    to the capacity's last row but one (``PLAN_POS``; the rows between, never
    written, hold zeros): each tick reads every row of the 32k context, with
    no prefill to 32768.  Then the proof: slot 0's V in layer 0 set to NaN
    at its last row, past its position, leaves every slot's logits finite,
    and at the row before its position makes slot 0's non-finite and no
    other slot's.  The pool is dropped after."""
    sc = engine_mod.ServeConfig(**PLAN_DECODE_SC)
    eng = engine_mod.InferenceEngine(base.cfg, params=base.params, sc=sc, device=dev)
    pool = eng.make_pool()
    rng = np.random.default_rng(31)
    for slot in range(sc.max_batch):
        prompt = rng.integers(0, eng.cfg.vocab_size, PLAN_PROMPT).astype(np.int32)
        eng.prefill_into_slot(pool, slot, prompt, rid=slot, budget=8)
        pool.slots[slot].pos = PLAN_POS
    kv_bytes = tree_bytes(pool.cache)
    tick = lambda: eng.masked_decode_step(pool)  # noqa: E731
    tick()  # the capture
    samples = []
    for _ in range(PLAN_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, finite = tick()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
        if not finite.all():
            fail("plan_decode: a slot's logits are not finite")
    graph = eng.step_graphs(pool)[("decode", 0)]
    graph.load(tok=pool.tok, pos=pool.positions(), active=pool.decode_mask())
    replay_ms = time_ms(graph.replay, reps=3, rounds=3)
    prof = profile_call(tick)
    v = pool.cache["v"]
    v[0, 0, PLAN_POS + 1] = float("nan")
    _, finite = tick()
    if not finite.all():
        fail(f"plan_decode: NaN in slot 0's V past its position gave finite {finite.tolist()}: "
             "the tick reads a row past the position")
    v[0, 0, PLAN_POS - 1] = float("nan")
    _, finite = tick()
    if finite[0] or not finite[1:].all():
        fail(f"plan_decode: NaN in slot 0's V before its position gave finite "
             f"{finite.tolist()}: the tick does not read every row through the position")
    report = {"pool": [sc.max_batch, sc.max_len], "kv_gb": r6(kv_bytes / 1e9),
              "positions": pool.positions().tolist(),
              "tick_ms_median": r6(statistics.median(samples)),
              "tick_ms": [r6(t) for t in samples], "replay_only_ms": r6(replay_ms),
              "reads_every_row_through_the_position": True, "skips_rows_past_it": True,
              "profiled": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                 "int8_matmul_device_ms", "device_launches",
                                                 "top_kernels_ms")}}
    del graph, pool, eng, v
    gc.collect()
    torch.cuda.empty_cache()
    return {"expect": {}, "report": report}


def plan_report(train: dict, decode: dict) -> dict:
    """Predicted (``cost_model.estimate_step`` on ``H100Chip``, full width,
    granite-3-8b cut to the paths' 8 layers) beside measured: the train
    path's step at train_4k over ``MeshPlan(dp=128)`` (2 x 4096 a card, as
    the path runs; the collective term apart: one card has no peer) and the
    32k decode tick at decode_32k over ``MeshPlan(dp=32)`` (4 slots a card,
    the int8 engine's pool), with ``GPUCostBackend``'s estimate of that
    engine and its Generator's pick on one card."""
    cfg = dataclasses.replace(get_config(GRANITE), num_layers=TRAIN_LAYERS)
    out = {"chip": DEFAULT_CHIP.name, "arch": GRANITE, "layers": TRAIN_LAYERS}

    shape, mesh = PLAN_TRAIN
    sh = SHAPES[shape]
    if (sh["global_batch"] // mesh["dp"], sh["seq_len"]) != (TRAIN_BATCH, TRAIN_SEQ):
        fail(f"plan: {shape} over dp {mesh['dp']} is not the train path's shape")
    r = cost_mod.estimate_step(cfg, shape, cost_mod.MeshPlan(**mesh))
    step = train["train_dense"]["step_s_median"]
    pred = {"compute": r.compute_s, "memory": r.memory_s,
            "max": max(r.compute_s, r.memory_s)}
    out["train"] = {
        "shape": shape, "mesh": mesh, "per_card": [TRAIN_BATCH, TRAIN_SEQ],
        "predicted_s": {k: r6(v) for k, v in pred.items()},
        "collective_s_apart": r6(r.collective_s),
        "hbm_gb_terms": {k: r6(v / 1e9) for k, v in
                         cost_mod.hbm_bytes_terms(cfg, shape, cost_mod.MeshPlan(**mesh)).items()},
        "measured_step_s": step,
        "measured_over_predicted": {k: r6(step / v) for k, v in pred.items()}}

    shape, mesh = PLAN_DECODE
    sh = SHAPES[shape]
    if (sh["global_batch"] // mesh["dp"], sh["seq_len"]) != tuple(decode["pool"]):
        fail(f"plan: {shape} over dp {mesh['dp']} is not the decode pool's shape")
    r = cost_mod.estimate_step(cfg, shape, cost_mod.MeshPlan(**mesh))
    backend = cost_mod.GPUCostBackend(cfg, shape, cost_mod.MeshPlan(**mesh))
    engine_point = DesignPoint.of(activation_impl=cfg.activation_impl,
                                           attention_impl="naive", precision="int8")
    int8 = backend.evaluate(engine_point).latency_s
    tick_s, replay_s = decode["tick_ms_median"] / 1e3, decode["replay_only_ms"] / 1e3
    pred = {"compute": r.compute_s, "memory": r.memory_s, "max": r.t_step_s,
            "gpu_backend_int8": int8}
    out["decode"] = {
        "shape": shape, "mesh": mesh, "per_card": decode["pool"],
        "predicted_s": {k: r6(v) for k, v in pred.items()},
        "hbm_gb_terms": {k: r6(v / 1e9) for k, v in
                         cost_mod.hbm_bytes_terms(cfg, shape, cost_mod.MeshPlan(**mesh)).items()},
        "measured_tick_s": r6(tick_s), "measured_replay_s": r6(replay_s),
        "tick_over_predicted": {k: r6(tick_s / v) for k, v in pred.items() if v},
        "replay_over_predicted": {k: r6(replay_s / v) for k, v in pred.items() if v}}
    res = generator_mod.Generator(backend, constraints_mod.ApplicationSpec(**PLAN_APP)).search(
        method="exhaustive", refine=False)
    best = res.best
    out["generator_pick"] = {
        "app": PLAN_APP, "point": best.point.as_dict(), "strategy": best.strategy,
        "score": r6(best.score), "latency_s": r6(best.estimate.latency_s),
        "engine_point": engine_point.as_dict(),
        "engine_is_the_pick": best.point == engine_point,
        "visited": res.visited, "pruned": len(res.pruned), "ranked": len(res.ranked)}
    return out


# ---------------------------------------------------------------------------
# examples: the port's examples/torch/ on the card
# ---------------------------------------------------------------------------
EXAMPLE_ARGS = {"quickstart": [], "generate_accelerator": [],
                "serve_workload": ["--n", "12"]}  # the reference's defaults but a smaller --n


def drive_examples(dev) -> dict:
    """``quickstart``, ``generate_accelerator`` and ``serve_workload`` (its
    reduced engine with int8 weights: K5) through their ``main`` on the
    card, each exiting 0; their printed lines go to the report.
    ``train_lm --quick`` runs as the train path's ``train_converge``."""
    report = {}
    for name, argv in EXAMPLE_ARGS.items():
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = example(name).main([*argv, "--device", str(dev)])
        lines = printed.getvalue().splitlines()
        if rc != 0:
            fail(f"examples: {name} exited {rc}: {lines[-3:]}")
        report[name] = {"argv": argv, "rc": rc, "seconds": r6(time.perf_counter() - t0),
                        "lines": lines}
    report["train_lm"] = "run by the train path's train_converge"
    return {"expect": {}, "report": report}


def plan_summary(plan: dict) -> dict:
    """The ``plan`` line: the report without the tick's samples and kernel
    table (``--out`` keeps them)."""
    tick = {k: v for k, v in plan["decode"]["tick"].items() if k not in ("tick_ms", "profiled")}
    tick["device_busy_ms"] = plan["decode"]["tick"]["profiled"]["device_busy_ms"]
    return dict(plan, decode=dict(plan["decode"], tick=tick))


EXAMPLE_RESULT_LINES = ("GOPS/s/W", "items in the same", "improvement", "DP(", "validation",
                        "continuous", "static", "-> continuous", "measured batch latency")


def examples_summary(report: dict) -> dict:
    """The ``examples`` line: each example's exit code, seconds and the
    lines that carry its results (``--out`` keeps every line)."""
    out = dict(report)
    for name in EXAMPLE_ARGS:
        part = report[name]
        lines = [ln.strip() for ln in part["lines"]]
        out[name] = {"rc": part["rc"], "seconds": part["seconds"],
                     "lines": [ln for ln in lines if ln.startswith(EXAMPLE_RESULT_LINES)][:10]}
    return out


def drive_main_path(dev) -> dict:
    """The paper-LSTM plan, then request batches through every mode.  Returns
    the launch counts it expects, and what it saw."""
    b, s, d, h = QUANT_SHAPE
    sb, ss, sd, sh, sl = STACK_SHAPE
    expect = {k: 0 for k in ("activation", "lstm_cell", "lstm_seq_f32", "lstm_seq_q8",
                             "lstm_stack_f32", "lstm_stack_q8")}
    plan = plan_paper_lstm(batch=PAPER_BATCH, device=dev)
    timed = 1 + 15  # compare_lstm_paths: one warm-up and n=15 samples per path
    expect["lstm_seq_f32"] += 1 + timed
    expect["lstm_cell"] += timed * plan["seq"]

    _, single = make_lstm(1000, b, s, d, h, 1, dev)
    _, stack = make_lstm(1001, sb, ss, sd, sh, sl, dev)
    worst = {}
    for req in range(REQUESTS):
        x = torch.from_numpy(
            np.random.default_rng(2000 + req).standard_normal((b, s, d)).astype(np.float32)).to(dev)
        want = lstm_apply(single[0], x, fused=True)
        for mode in SINGLE_MODES:
            got = lstm_apply(single[0], x, fused=mode)
            if got.shape != (b, s, h):
                fail(f"lstm_apply {mode}: shape {tuple(got.shape)}")
            tol = Q8_VS_F32 if mode == "pallas_seq_q8" else TOL_F32
            key = f"lstm_apply/{mode}"
            worst[key] = max(worst.get(key, 0.0), compare(got, want, "exact", tol, key))
        expect["lstm_cell"] += s
        expect["lstm_seq_f32"] += 1
        expect["lstm_seq_q8"] += 1

        want = lstm_stack_apply(stack, x, fused=True)
        for mode in STACK_MODES:
            got = lstm_stack_apply(stack, x, fused=mode)
            if got.shape != (sb, ss, sh):
                fail(f"lstm_stack_apply {mode}: shape {tuple(got.shape)}")
            tol = Q8_VS_F32 if str(mode).endswith("q8") else TOL_F32
            key = f"lstm_stack_apply/{mode}"
            worst[key] = max(worst.get(key, 0.0), compare(got, want, "exact", tol, key))
        expect["lstm_stack_f32"] += 1          # one launch, not L
        expect["lstm_stack_q8"] += 1
        expect["lstm_seq_f32"] += sl
        expect["lstm_seq_q8"] += sl
        expect["lstm_cell"] += sl * ss

        # the gate nonlinearities of the request's output, every variant (RQ1)
        for fn in ("sigmoid", "tanh", "silu", "gelu"):
            for impl in IMPLS:
                y = ops.activation(want, fn=fn, impl=impl)
                ref = activation_plain(want, fn=fn, impl=impl)
                key = f"activation/{impl}"
                worst[key] = max(worst.get(key, 0.0),
                                 compare(y, ref, impl, TOL_F32, key, same_inputs=True))
                expect["activation"] += 1
    torch.cuda.synchronize()
    return {"expect": expect, "plan": plan, "worst": {k: r6(v) for k, v in worst.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    ap.add_argument("--parent", default=None, type=pathlib.Path,
                    help="a checkout of the parent commit (git archive): its lstm_cell and "
                         "flash_attention kernels are built and timed beside this one's")
    ap.add_argument("--traced-peaks", default=None, type=pathlib.Path, metavar="FILE",
                    help="only trace the train steps whose peak the run measures, on fake "
                         "tensors on the CPU, and write their traced peaks to FILE (the "
                         "multi_device phase runs this in a process of its own)")
    args = ap.parse_args(argv)
    if args.traced_peaks is not None:
        traced_peaks(args.traced_peaks)
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # f32 means f32: no TF32 in any product of a plain version or of cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([runtime._find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "unknown")
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": release, "gpu": smi, "allow_tf32": False,
           "cudnn_allow_tf32": False}
    print("env " + json.dumps(env), flush=True)
    print(smi, flush=True)
    runtime.load_kernels()
    sass = sass_tensor_ops()
    sass_summary = None if sass is None else {
        family: {"op": op, "instantiations": sum(c["family"] == family for c in sass.values()),
                 "fewest": min(c["count"] for c in sass.values() if c["family"] == family)}
        for family, op in TENSOR_CORE_KERNELS.items()}
    print("build " + json.dumps({"seconds": r6(runtime.build_seconds()),
                                 "library": "build/repro_torch", "sources": sorted(
                                     p.name for p in runtime.CSRC_DIR.glob("*.cu")),
                                 "sass_tensor_ops": sass_summary}), flush=True)

    warm_card(dev)  # after the build, which leaves the card idle
    phases: dict[str, float] = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases[name] = r6(time.perf_counter() - t0)
        print("phase " + json.dumps({"name": name, "seconds": phases[name]}), flush=True)
        return out

    kernels = [phase("activation", check_activation, dev),
               phase("lstm_cell", check_cell, dev, args.parent),
               phase("lstm_seq_f32", check_seq, dev, False),
               phase("lstm_seq_q8", check_seq, dev, True),
               phase("lstm_stack_f32", check_stack, dev, False),
               phase("lstm_stack_q8", check_stack, dev, True),
               phase("int8_matmul", check_int8_matmul, dev),
               phase("flash_attention", check_flash, dev, args.parent),
               phase("decode_attention", check_decode_attention, dev)]
    host = phase("host_path", host_path, dev)
    chip_model = phase("chip_model", check_chip_model, dev)
    tuner = phase("tuner", check_tuner, dev)
    energy = phase("energy", measure_energy, dev)
    quantize_on_card = phase("quantize_on_card", check_quantize_on_card, dev)
    init_on_card = phase("init_on_card", check_init_on_card, dev)

    # Each path runs with the counters set to 0 just before it and read just
    # after; a kernel's "launches" are those of the path it belongs to.
    driven, counts_by_path, k5_seen = {}, {}, {}
    paths = {"lstm": drive_main_path, "serve_dense": drive_serve_dense,
             "serve_engine": lambda d: drive_serve_engine(d, driven["serve_dense"]["engine"]),
             "serve_paged": lambda d: drive_serve_paged(d, driven["serve_dense"]["engine"]),
             "duty_cycle": lambda d: drive_duty_cycle(d, driven["serve_dense"]["engine"], energy),
             "serve_scheduler": lambda d: drive_serve_scheduler(d, driven["serve_dense"]["engine"]),
             "plan_decode": lambda d: drive_plan_decode(d, driven["serve_dense"]["engine"]),
             "serve_moe": drive_serve_moe, "serve_ssm": drive_serve_ssm,
             "serve_audio": drive_serve_audio, "serve_vlm": drive_serve_vlm,
             "flash_attention": drive_flash_path, "examples": drive_examples}
    for name, drive in paths.items():
        runtime.reset_launch_counts()
        calls = tracing.counter("attn.decode_calls")
        with k5_shapes_recorded(k5_seen, name), plain_decode_calls() as on_cpu:
            driven[name] = phase(f"path:{name}", drive, dev)
        counts_by_path[name] = runtime.launch_counts()
        # every decode attention call on the card launches K7 (a replay adds
        # its capture's calls and launches alike)
        on_card = tracing.counter("attn.decode_calls") - calls - on_cpu[0]
        if on_card:
            driven[name]["expect"]["decode_attention"] = on_card
    k5_entry = next(k for k in kernels if k["name"] == "int8_matmul")
    path_shapes = phase("int8_path_shapes", check_int8_path_shapes, dev, k5_seen)
    k5_entry["path_shapes"] = {k: v for k, v in path_shapes.items() if k not in ("legend", "shapes")}
    k5_entry["path_shapes"]["bitwise_equal"] = len(path_shapes["shapes"])
    for k in kernels:
        on = [p for p in paths if k["name"] in driven[p]["expect"]]
        k["launches_by_path"] = {p: counts_by_path[p].get(k["name"], 0) for p in on}
        for path in on:
            launches, want = k["launches_by_path"][path], driven[path]["expect"][k["name"]]
            if launches < 1:
                fail(f"the {path} path never launched {k['name']}")
            if launches != want:
                fail(f"{k['name']}: {launches} launches on the {path} path, {want} expected")
        k["path"] = on[0]
        k["launches"] = k["launches_by_path"][on[0]]
    counts = counts_by_path["lstm"]
    serve = driven["serve_dense"]["report"]
    serve["launches"] = counts_by_path["serve_dense"]
    serve["quantize_on_card"] = quantize_on_card
    serve["init_on_card"] = init_on_card
    dense_engine = driven["serve_dense"].pop("engine")
    serve["block_card_vs_cpu"] = phase("block_card_vs_cpu", check_block_card_vs_cpu,
                                       dense_engine, dev)
    serve["profile"] = phase("serve_profile", profile_serve, dense_engine, dev)
    del dense_engine
    engine_report = driven["serve_engine"]["report"]
    engine_report["launches"] = counts_by_path["serve_engine"]
    engine_report["ticks"] = phase("serve_engine_ticks", time_engine_ticks,
                                   driven["serve_engine"])
    for key in ("engine", "pools", "drafts"):
        driven["serve_engine"].pop(key)
    # the training path, after every serving engine is dropped
    runtime.reset_launch_counts()
    train_report = phase("path:train", drive_train, dev)["report"]
    train_report["launches"] = runtime.launch_counts()
    decode_report = driven["plan_decode"]["report"]
    decode_report["launches"] = counts_by_path["plan_decode"]
    plan = phase("plan", plan_report, train_report, decode_report)
    plan["decode"]["tick"] = decode_report
    # the multi-device layer: its ranks count their own K5 launches around the sharded MoE
    multi = phase("path:multi_device", drive_multi_device, dev,
                  train_report["train_dense"]["step_peak"])
    multi_report = multi["report"]
    k5_entry["launches_by_path"]["multi_device"] = multi["k5_launches"]
    examples_report = driven["examples"]["report"]
    examples_report["launches"] = counts_by_path["examples"]
    if examples_report["launches"].get("int8_matmul", 0) < 1:
        fail("examples: serve_workload never launched int8_matmul")
    paged_report = driven["serve_paged"]["report"]
    paged_report["launches"] = counts_by_path["serve_paged"]
    duty_report = driven["duty_cycle"]["report"]
    duty_report["launches"] = counts_by_path["duty_cycle"]
    duty_report["t_inf_beside_the_replayed_tick"] = {
        "t_inf_s": duty_report["t_inf_s"],
        "model_calls_of_t_inf": generate_calls(DUTY_LATENCY["new_tokens"]),
        "replayed_decode_tick_ms_median": engine_report["ticks"]["tick_ms_median"][
            "decode_replayed"],
        "eager_decode_tick_ms_median": engine_report["ticks"]["tick_ms_median"]["decode_eager"],
        "profile_uses": "t_inf_s (eager generate)"}
    sched_report = driven["serve_scheduler"]["report"]
    sched_report["launches"] = counts_by_path["serve_scheduler"]
    sched_report["int8_matmul_per_committed_token"] = r6(
        counts_by_path["serve_scheduler"]["int8_matmul"] / sched_report["committed_tokens"])
    med = engine_report["ticks"]["tick_ms_median"]
    sched_report["beside_replayed_tick"] = {  # serve_engine's engine: the same weights and pool
        "decode_replayed_ms": med["decode_replayed"], "verify_replayed_ms": med["verify_replayed"],
        "decode_eager_ms": med["decode_eager"], "verify_eager_ms": med["verify_eager"]}
    sched_line = json.dumps(scheduler_summary(sched_report))
    if len(sched_line) > 2000:
        fail(f"the serve_scheduler line is {len(sched_line)} bytes, over 2 KB")
    moe_report = driven["serve_moe"]["report"]
    moe_report["launches"] = counts_by_path["serve_moe"]
    ssm_report = driven["serve_ssm"]["report"]
    ssm_report["launches"] = counts_by_path["serve_ssm"]
    audio_report = driven["serve_audio"]["report"]
    audio_report["launches"] = counts_by_path["serve_audio"]
    vlm_report = driven["serve_vlm"]["report"]
    vlm_report["launches"] = counts_by_path["serve_vlm"]
    driven = driven["lstm"]

    lw = paper_workload()
    medians_us = phase("lstm_bench", lambda: {
        "paths_paper": bench.compare_lstm_paths(PAPER_BATCH, lw.seq, lw.d_in, lw.hidden, device=dev),
        "paths_scaled": bench.compare_lstm_paths(*SCALED_SHAPE, device=dev),
        "quant": bench.compare_lstm_quant(*QUANT_SHAPE, device=dev),
        "stack_f32": bench.compare_lstm_stack(*STACK_SHAPE, device=dev),
        "stack_q8": bench.compare_lstm_stack(*STACK_SHAPE, quantized=True, device=dev),
    })
    main_path = {
        "requests": REQUESTS, "shape": list(QUANT_SHAPE), "stack_shape": list(STACK_SHAPE),
        "plan_paper_lstm": {k: (r6(v) if isinstance(v, float) else v)
                            for k, v in driven["plan"].items()},
        "launches": counts, "max_abs_err_vs_fused_true": driven["worst"],
        "tolerance": {"f32": TOL_F32, "q8_vs_f32": Q8_VS_F32},
        "medians_us": {k: [r6(a), r6(b)] for k, (a, b) in medians_us.items()},
        "medians_us_legend": {
            "paths_*": "[sequence kernel, per-step kernel loop]",
            "quant": "[f32 sequence kernel, int8 sequence kernel]",
            "stack_*": "[layer-fused stack, L sequential sequence kernels]"},
        "phase_seconds": phases, "seconds": r6(time.perf_counter() - t_start),
    }
    main_path["trace_check"] = TRACE_CHECK
    report = {"env": env, "kernels": kernels, "main_path": main_path, "serve_dense": serve,
              "serve_engine": engine_report, "serve_paged": paged_report,
              "duty_cycle": duty_report,
              "serve_scheduler": sched_report,
              "serve_moe": moe_report, "serve_ssm": ssm_report,
              "serve_audio": audio_report, "serve_vlm": vlm_report, "train": train_report,
              "plan": plan, "examples": examples_report, "multi_device": multi_report,
              "int8_path_shapes": path_shapes, "host_path": host,
              "chip_model": chip_model,
              "tuner": tuner, "energy": energy,
              "lut_seen": {k: {n: r6(v) for n, v in d.items()} for k, d in LUT_SEEN.items()},
              "tensor_core_kernels": {"ptxas": ptxas_usage(runtime.compile_log()),
                                      "sass": sass,
                                      "flash_dynamic_smem_bytes": {
                                          kind: {d: flash_smem_bytes(d, kind) for d in HEAD_DIMS}
                                          for kind in ("float32", "bfloat16")}},
              "nvcc_log": runtime.compile_log()}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))

    print("serve_dense " + json.dumps(serve), flush=True)
    print("serve_engine " + json.dumps(engine_report), flush=True)
    print("serve_paged " + json.dumps(paged_report), flush=True)
    print("serve_moe " + json.dumps(moe_report), flush=True)
    print("serve_ssm " + json.dumps(ssm_report), flush=True)
    print("serve_audio " + json.dumps(audio_report), flush=True)
    print("serve_vlm " + json.dumps(vlm_report), flush=True)
    print("duty_cycle " + json.dumps(duty_report), flush=True)
    print("serve_scheduler " + sched_line, flush=True)
    print("train " + json.dumps(train_summary(train_report)), flush=True)
    print("plan " + json.dumps(plan_summary(plan)), flush=True)
    print("examples " + json.dumps(examples_summary(examples_report)), flush=True)
    print("multi_device " + json.dumps(multi_report), flush=True)
    print("traced_peaks " + json.dumps(multi_report["traced_peaks"]), flush=True)
    print("int8_path_shapes " + json.dumps(path_shapes), flush=True)
    print("host_path " + json.dumps(host), flush=True)
    print("chip_model " + json.dumps(chip_model), flush=True)
    print("tuner " + json.dumps(tuner_summary(tuner)), flush=True)
    print("energy " + json.dumps(energy), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print("main_path " + json.dumps(main_path), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
