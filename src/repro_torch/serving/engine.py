"""Serving engine: batched prefill → greedy decode, the slot path of
continuous batching, and the workload-aware duty-cycle layer on top.

Two layers, as in the reference:

  * ``InferenceEngine`` — the real execution path on the card (or, when
    asked, the CPU): ``generate``, and ``make_pool`` →
    ``prefill_into_slot`` or chunked prefill (``begin_chunked_prefill`` →
    ``chunked_prefill_step`` → ``finish_chunked_prefill``) →
    ``masked_decode_step`` or ``masked_speculative_step``, with
    ``poison_slot`` / ``resume_into_slot`` for quarantine and re-admission.

  * ``WorkloadAwareServer`` — the paper's RQ2 strategies (On-Off /
    Idle-Waiting / Slow-Down / adaptive with a predefined or learned
    threshold, ``core/workload.py``) applied to a served model: its
    measured batch latency with ``H100Chip``'s constants, where
    "configuration" is loading the kernel library and refilling the
    weights over PCIe (``gpu_reload_costs``), the counterpart of the
    reference's ``tpu_reload_costs``.

Ported: the contiguous engine of every family of the JAX package (the
dense family, and vlm with its front-end stub of ``frontend_seq`` patch
rows; granite-moe's GQA attention and deepseek's MLA over its compressed
cache, the MoE FFN on its dense path; mamba2's per-layer conv tail and SSM
state, zamba2's shared attention block with a K/V cache per application;
whisper's encoder over its front-end stub of ``encoder_seq`` frames and
its decoder's cross K/V, filled once at admission and read by every later
tick), in full precision or with int8 weights (``ArchConfig.quant =
"int8"``, every attention, MLP, expert, Mamba2, shared-block, encoder and
cross-attention projection through the ``int8_matmul`` kernel, each expert
einsum one launch over the expert axis), ``spec_slack`` included.  Two
families need a line of their own here: the front-end stubs (vlm, audio),
and a chunked audio group's cross K/V, which ``begin_chunked_prefill``
fills from ``encoder_cross_cache`` before the first chunk.  Everything
else (prefill, chunked prefill on the group's own cache, poison/resume,
``generate``) goes through the model's entry points, and the verify tick's
``commit_verify`` rolls each row's recurrent state forward to that row's
own accepted count (what the JAX engine does per slot under ``vmap``).
The options whose modules are not ported raise ``NotImplementedError`` at
construction: the paged cache and int8 KV pages (ROADMAP Queue A item 10),
and fault injection and the energy budget, whose profiles and ledgers
(``serving/faults.py``, ``serving/power.py``) are ported but whose reader,
the scheduler (item 11), is not.  Without the paged pool,
the paged branches of the reference's slot functions have no counterpart
here.

How the JAX engine's idioms are expressed here:

* ``jit`` becomes a captured CUDA graph for the two ticks that run at one
  shape for a pool's whole life: ``masked_decode_step`` and
  ``masked_speculative_step`` (per K) replay a ``serving/graphs.StepGraph``
  on a CUDA pool, captured at the first tick; a CPU pool runs the same step
  eagerly.  Prefill, ``generate`` and the chunked-prefill steps run
  eagerly: their lengths vary per call.
* ``donate_argnums`` becomes an in-place cache update.
* ``vmap`` over a pool's slots becomes one batched call with a position per
  row: the masked decode and verify steps run all slots as one batch, each
  row at its own position.  The numbers are the same, since each row's
  activation quantization and each output element depend only on that row;
  the int8 projections become one launch each, M = max_batch (decode) or
  max_batch x (K + 1) (verify).
"""
from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.energy import DEFAULT_CHIP, H100Chip
from repro_torch.core.workload import AccelProfile, break_even_tau, learn_tau, simulate
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import (
    commit_verify,
    decode_step,
    decode_verify,
    encoder_cross_cache,
    init_model,
    prefill,
    prefill_chunk,
)
from repro_torch.models.params import init_params
from repro_torch.serving.graphs import StepGraph, signature
from repro_torch.serving.kv_cache import cache_defs
from repro_torch.serving.slots import SlotPool, grow_cache


def gpu_reload_costs(cfg: ArchConfig, chip: H100Chip = DEFAULT_CHIP, *,
                     chips: int = 1, weight_bytes: float | None = None
                     ) -> tuple[float, float]:
    """(t_reload_s, e_reload_j) of the card's "configuration" analogue after
    a power-off: loading the kernel library and refilling the weights over
    PCIe (``H100Chip.reload_time``), at idle power on every card.  The
    counterpart of the reference's ``tpu_reload_costs``, with the same
    arithmetic: the default weight bytes are 2 a parameter (bf16), split
    over ``chips``."""
    if weight_bytes is None:
        weight_bytes = 2.0 * cfg.param_count() / max(chips, 1)
    t_reload = chip.reload_time(weight_bytes)
    return t_reload, t_reload * chip.p_idle_w * chips


@dataclasses.dataclass
class ServeConfig:
    """Field for field the JAX package's ``ServeConfig``."""

    max_batch: int = 8
    max_len: int = 256  # admission bound (prompt + generated)
    greedy: bool = True
    # spare cache rows past max_len for speculative verify windows
    spec_slack: int = 0
    # seeded fault-injection scenario (serving/faults.py)
    faults: object | None = None
    # paged KV cache (serving/pages.py)
    paged: bool = False
    page_size: int = 16
    num_pages: int | None = None
    share_prefix: bool = False
    # int8 KV page residency (paged only)
    kv_quant: str | None = None
    # hard energy-budget enforcement (serving/power.py)
    energy_budget_j: float | None = None
    budget_window_s: float = 1.0


def _refuse_unported(sc: ServeConfig) -> None:
    unported = {
        "paged": (sc.paged, "the paged KV cache (ROADMAP Queue A item 10)"),
        "share_prefix": (sc.share_prefix, "prefix sharing over pages (ROADMAP Queue A item 10)"),
        "kv_quant": (sc.kv_quant is not None, "int8 KV pages (ROADMAP Queue A item 10)"),
        "faults": (sc.faults is not None,
                   "the scheduler, which reads it (ROADMAP Queue A item 11; the fault "
                   "profiles of serving/faults.py are ported)"),
        "energy_budget_j": (sc.energy_budget_j is not None,
                            "the scheduler, which enforces it (ROADMAP Queue A item 11; the "
                            "ledger of serving/power.py is ported)"),
    }
    for name, (asked, what) in unported.items():
        if asked:
            raise NotImplementedError(f"ServeConfig.{name} needs {what}, not ported yet")
    if not sc.greedy:
        raise NotImplementedError("only greedy decoding exists, as in the JAX engine")


class InferenceEngine:
    """Batched prefill → decode loop (every family: dense, vlm, moe, ssm,
    hybrid, audio)."""

    def __init__(self, cfg: ArchConfig, params=None, sc: ServeConfig | None = None,
                 seed: int = 0, device=None):
        """``params`` (a tree of tensors, full precision or already
        quantized) or, when ``None``, random weights drawn from a
        ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``
        means the card)."""
        self.cfg = cfg
        self.sc = sc or ServeConfig()
        _refuse_unported(self.sc)
        if cfg.quant not in (None, "int8"):
            raise ValueError(f"unsupported quant {cfg.quant!r}")
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_model(cfg, gen, self.device, quantize=cfg.quant == "int8")
        if cfg.quant == "int8":
            # idempotent: quantized leaves pass through
            from repro_torch.models.quant import quantize_params

            params = quantize_params(params, cfg)
        self.params = params
        # physical cache rows per slot: the admission bound plus the
        # speculative verify slack
        self.capacity = self.sc.max_len + self.sc.spec_slack
        # pool -> {(kind, K): StepGraph}; a pool's graphs go with it
        self._graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def _frontend_stub(self, batch: int):
        """The front-end's stand-in, zeros as in the JAX engine: vlm's
        (batch, frontend_seq, d_model) patch embeddings, whisper's (batch,
        encoder_seq, d_model) frames; ``None`` without a front-end."""
        cfg = self.cfg
        if cfg.frontend == "vision":
            seq = cfg.frontend_seq
        elif cfg.frontend == "audio":
            seq = cfg.encoder_seq
        elif cfg.frontend is None:
            return None
        else:
            raise ValueError(f"unknown frontend {cfg.frontend!r}")
        return torch.zeros((batch, seq, cfg.d_model), dtype=cfg.dtype, device=self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, new_tokens: int) -> np.ndarray:
        """prompts: (B, S0) int32 → (B, new_tokens) greedy continuations."""
        b, s0 = prompts.shape
        if b > self.sc.max_batch or s0 + new_tokens > self.sc.max_len:
            raise ValueError(f"batch {b} x ({s0} + {new_tokens}) exceeds max_batch "
                             f"{self.sc.max_batch} / max_len {self.sc.max_len}")
        toks = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        logits, cache = prefill(self.params, toks, self.cfg,
                                frontend_embeds=self._frontend_stub(b))
        cache = grow_cache(self.cfg, cache, self.capacity)
        out = np.zeros((b, new_tokens), np.int32)
        tok = torch.argmax(logits, dim=-1)[:, None]
        for i in range(new_tokens):
            out[:, i] = tok[:, 0].cpu().numpy()
            logits, cache = decode_step(self.params, cache, tok, s0 + i, self.cfg)
            tok = torch.argmax(logits, dim=-1)[:, None]
        return out

    # -- continuous-batching execution path ---------------------------------
    def make_pool(self) -> SlotPool:
        return SlotPool(self.cfg, max_batch=self.sc.max_batch, max_len=self.sc.max_len,
                        slack=self.sc.spec_slack, device=self.device)

    @torch.inference_mode()
    def prefill_into_slot(self, pool: SlotPool, slot: int, prompt: np.ndarray,
                          *, rid: int, budget: int) -> int:
        """Prefill one request (batch 1) and admit it into ``slot``.  Returns
        the request's first emitted token."""
        prompt = np.asarray(prompt, np.int32)
        (s0,) = prompt.shape
        if s0 + budget > self.sc.max_len:
            raise ValueError(f"prompt {s0} + budget {budget} exceeds max_len {self.sc.max_len}")
        toks = torch.as_tensor(prompt.astype(np.int64), device=self.device)[None]
        logits, cache = prefill(self.params, toks, self.cfg,
                                frontend_embeds=self._frontend_stub(1))
        cache = grow_cache(self.cfg, cache, self.capacity)
        first = int(torch.argmax(logits[0, : self.cfg.vocab_size]))
        pool.admit(slot, cache, rid=rid, pos=s0, budget=budget, first_tok=first, prompt=prompt)
        return first

    @torch.inference_mode()
    def masked_decode_step(self, pool: SlotPool) -> tuple[np.ndarray, np.ndarray]:
        """One decode step over the whole pool.  Returns

          next:   (max_batch,) int32 — next greedy token per slot; entries
                  for non-decoding slots are garbage
          finite: (max_batch,) bool — the finiteness guard: False where the
                  slot's logits hold NaN/Inf (a poisoned cache, an
                  overflow); such a slot's token must not be committed, and
                  the slot is quarantined and re-admitted
                  (``resume_into_slot``).

        Non-decoding slots (free, or admitting: their chunked prefill is in
        flight) step at position 0, into dead rows that the next admit
        overwrites.  Host-side bookkeeping (advancing positions, retiring)
        is the caller's, as in the JAX engine.  On a CUDA pool the step is a
        replayed graph (``step_graphs``).
        """
        g = self._graph(pool, "decode", 0)
        out = g(tok=pool.tok, pos=pool.positions(), active=pool.decode_mask())
        return out["next"].cpu().numpy(), out["finite"].cpu().numpy()

    def _decode_tick(self, cache, tok, pos, active):
        """The masked decode step on static inputs (B,): every decoding slot
        at its own position, the others at 0."""
        v = self.cfg.vocab_size
        pos = torch.where(active, pos, torch.zeros_like(pos))
        logits, _ = decode_step(self.params, cache, tok[:, None], pos, self.cfg)
        return {"logits": logits, "next": torch.argmax(logits[:, :v], dim=-1).to(torch.int32),
                "finite": torch.isfinite(logits[:, :v]).all(dim=-1)}

    def _verify_tick(self, cache, tok, drafts, pos, active):
        """One ``decode_verify`` over all slots' K+1 windows (the next decode
        input, then the K drafts), greedy prefix acceptance and
        ``commit_verify`` at each row's own accepted count; the finiteness
        flag covers the whole window."""
        cfg, v = self.cfg, self.cfg.vocab_size
        pos = torch.where(active, pos, torch.zeros_like(pos))
        tokens = torch.cat([tok[:, None], drafts], dim=1)  # (B, K+1)
        logits, cache = decode_verify(self.params, cache, tokens, pos, cfg)
        g = torch.argmax(logits[..., :v], dim=-1).to(torch.int32)
        fin = torch.isfinite(logits[..., :v]).flatten(1).all(dim=1)
        # accept the longest prefix of drafts matching the greedy chain
        ok = torch.cumprod((tokens[:, 1:] == g[:, :-1]).to(torch.int32), dim=1)
        accepted = ok.sum(dim=1).to(torch.int32)
        commit_verify(cache, accepted, cfg)
        return {"logits": logits, "tokens": g, "accepted": accepted, "finite": fin}

    def _graph(self, pool: SlotPool, kind: str, k: int) -> StepGraph:
        """The pool's captured decode (``k`` = 0) or verify tick, built anew
        when the pool's cache is not the one it was captured on."""
        graphs = self._graphs.setdefault(pool, {})
        g = graphs.get((kind, k))
        if g is None or g.signature != signature(pool.cache, pool.max_batch, k):
            b, dev = pool.max_batch, self.device
            inputs = {"tok": torch.zeros(b, dtype=torch.int64, device=dev)}
            if k:
                inputs["drafts"] = torch.zeros((b, k), dtype=torch.int64, device=dev)
            inputs["pos"] = torch.zeros(b, dtype=torch.int64, device=dev)
            inputs["active"] = torch.zeros(b, dtype=torch.bool, device=dev)
            step = self._verify_tick if k else self._decode_tick
            g = graphs[(kind, k)] = StepGraph(step, pool.cache, inputs, pool.max_batch, k)
        return g

    def step_graphs(self, pool: SlotPool) -> dict[tuple[str, int], StepGraph]:
        """The pool's step graphs by (kind, K): ("decode", 0), ("verify", K)."""
        return dict(self._graphs.get(pool, {}))

    # -- fault injection and recovery ----------------------------------------
    @torch.inference_mode()
    def poison_slot(self, pool: SlotPool, slot: int) -> None:
        """Overwrite ``slot``'s cache rows with NaN, in place (an injected
        fault).  The next masked decode or verify tick reports the slot
        non-finite; recovery (``resume_into_slot``) is the caller's."""
        for leaf in pool.cache.values():
            if leaf.is_floating_point():
                leaf[:, slot] = float("nan")

    @torch.inference_mode()
    def resume_into_slot(self, pool: SlotPool, slot: int, context: np.ndarray, *,
                         rid: int, budget: int, emitted: int, next_tok: int) -> None:
        """Re-admit a quarantined (retired) request: prefill its committed
        context (prompt + all but the last emitted token) and land it in
        ``slot``, overwriting the poisoned rows (every leaf: whisper's cross
        K/V come from the prefill's encoder pass).  ``next_tok``, the last
        committed token, is the slot's next decode input, so the greedy
        continuation is the fault-free run's."""
        context = np.asarray(context, np.int32)
        (s,) = context.shape
        if s + (budget - emitted) + 1 > self.sc.max_len:
            raise ValueError(f"resume context {s} + remaining budget {budget - emitted} "
                             f"exceeds max_len {self.sc.max_len}")
        toks = torch.as_tensor(context.astype(np.int64), device=self.device)[None]
        _, cache = prefill(self.params, toks, self.cfg, frontend_embeds=self._frontend_stub(1))
        cache = grow_cache(self.cfg, cache, self.capacity)
        pool.admit(slot, cache, rid=rid, pos=s, budget=budget, first_tok=next_tok,
                   emitted=emitted)

    # -- speculative multi-token decode --------------------------------------
    @torch.inference_mode()
    def masked_speculative_step(self, pool: SlotPool, drafts: np.ndarray
                                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One speculative verify tick over the whole pool.

        ``drafts``: (max_batch, K) candidate tokens per slot (garbage for
        non-decoding slots).  One pass scores every slot's K+1 window at the
        slot's own position and commits each slot's cache to its accepted
        prefix.  Returns

          tokens:   (max_batch, K+1) int32 — the greedy token after each
                    window position
          accepted: (max_batch,) int32 — accepted drafts a in [0, K]; the
                    slot emits tokens[:a+1], and tokens[a] is its next input
          finite:   (max_batch,) bool — the finiteness guard over the whole
                    window (see ``masked_decode_step``)

        Bookkeeping (``SlotPool.advance``, retirement, budget truncation) is
        the caller's.  On a CUDA pool the tick is a replayed graph, one per K.
        """
        drafts = np.asarray(drafts, np.int32)
        k = drafts.shape[1] if drafts.ndim == 2 else 0
        if drafts.shape != (pool.max_batch, k) or k < 1:
            raise ValueError(f"drafts must be (max_batch={pool.max_batch}, K >= 1), "
                             f"got {drafts.shape}")
        if pool.slack < k:
            raise ValueError(f"speculative verify of {k} drafts needs spec_slack >= {k} spare "
                             f"cache rows (have {pool.slack}); see ServeConfig.spec_slack")
        g = self._graph(pool, "verify", k)
        out = g(tok=pool.tok, drafts=drafts, pos=pool.positions(), active=pool.decode_mask())
        return (out["tokens"].cpu().numpy(), out["accepted"].cpu().numpy(),
                out["finite"].cpu().numpy())

    # -- chunked prefill ------------------------------------------------------
    @torch.inference_mode()
    def begin_chunked_prefill(self, pool: SlotPool, slots: list[int], prompts: np.ndarray, *,
                              rids: list[int], budgets: list[int]) -> "ChunkedPrefillState":
        """Reserve ``slots`` for a same-length admission group and build the
        group's own full-capacity cache (batch = group size; for audio its
        cross K/V filled from ``encoder_cross_cache`` of the front-end stub,
        cast to the cache's type).  The group prefills outside the pool,
        whose masked decode keeps serving the decoding slots between chunks;
        ``finish_chunked_prefill`` lands each row in its reserved slot."""
        prompts = np.asarray(prompts, np.int32)
        k, s0 = prompts.shape
        if not len(slots) == len(rids) == len(budgets) == k:
            raise ValueError(f"{k} prompts need as many slots, rids and budgets")
        for rid, budget in zip(rids, budgets):
            if s0 + budget > self.sc.max_len:
                raise ValueError(f"request {rid}: prompt {s0} + budget {budget} "
                                 f"exceeds max_len {self.sc.max_len}")
        for slot, rid, budget in zip(slots, rids, budgets):
            if not pool.admitting[slot]:  # a scheduler may have reserved already
                pool.reserve(slot, rid=rid, s0=s0, budget=budget)
        cache = init_params(cache_defs(self.cfg, batch=k, max_len=self.capacity),
                            torch.Generator(), self.device)
        if self.cfg.family == "audio":
            ck, cv = encoder_cross_cache(self.params, self.cfg, self._frontend_stub(k))
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)
        return ChunkedPrefillState(prompts=prompts, rids=list(rids), budgets=list(budgets),
                                   slots=list(slots), cache=cache,
                                   frontend=self._chunk_frontend(k))

    def _chunk_frontend(self, batch: int):
        """The vlm frontend stub padded to cache capacity on the sequence
        axis, so that every chunk can slice it at its offset."""
        if self.cfg.family != "vlm":
            return None
        return torch.zeros((batch, self.capacity, self.cfg.d_model), dtype=self.cfg.dtype,
                           device=self.device)

    def chunk_step_probe(self, batch: int, chunk_tokens: int):
        """A zero-argument callable that runs one representative chunked
        prefill step (a chunk of zeros at position 0 on a fresh
        full-capacity cache, rewritten in place by every call) and returns
        its logits, for calibration timing.  Its cost does not depend on the
        position: attention spans the whole capacity, dead rows masked.
        Whisper's cross K/V stay zero, as in the JAX engine: the step's
        cost does not depend on their values."""
        cache = init_params(cache_defs(self.cfg, batch=batch, max_len=self.capacity),
                            torch.Generator(), self.device)
        toks = torch.zeros((batch, chunk_tokens), dtype=torch.int64, device=self.device)
        fe = self._chunk_frontend(batch)

        @torch.inference_mode()
        def probe():
            return prefill_chunk(self.params, cache, toks, 0, self.cfg, frontend_embeds=fe)[0]

        return probe

    @torch.inference_mode()
    def chunked_prefill_step(self, st: "ChunkedPrefillState", chunk_tokens: int) -> int:
        """Advance the admitting group by one chunk of at most
        ``chunk_tokens`` prompt tokens; returns how many it took.  After the
        last chunk ``st.first`` holds each request's first emitted token."""
        if st.done:
            raise ValueError("the group's prefill is done")
        t = min(chunk_tokens, st.s0 - st.pos)
        toks = torch.as_tensor(st.prompts[:, st.pos:st.pos + t].astype(np.int64),
                               device=self.device)
        logits, st.cache = prefill_chunk(self.params, st.cache, toks, st.pos, self.cfg,
                                         frontend_embeds=st.frontend)
        st.pos += t
        if st.done:
            st.first = torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1).to(
                torch.int32).cpu().numpy()
        return t

    @torch.inference_mode()
    def finish_chunked_prefill(self, pool: SlotPool, st: "ChunkedPrefillState") -> np.ndarray:
        """Land each prefilled row in its reserved slot (admitting →
        decoding) and return the group's first emitted tokens."""
        if not st.done or st.first is None:
            raise ValueError("the group's prefill is not done")
        for j, slot in enumerate(st.slots):
            row = {key: t[:, j:j + 1] for key, t in st.cache.items()}
            pool.activate(slot, row, rid=st.rids[j], pos=st.s0, budget=st.budgets[j],
                          first_tok=int(st.first[j]))
        return st.first

    def cancel_chunked_prefill(self, pool: SlotPool, st: "ChunkedPrefillState") -> None:
        """Abort an in-flight admitting group: retire its reserved slots."""
        for slot in st.slots:
            pool.retire(slot)


@dataclasses.dataclass
class ChunkedPrefillState:
    """One in-flight same-length admission group (chunked prefill).  The
    reference's ``shared_len`` and ``pins`` belong to the paged pool's prefix
    sharing (ROADMAP Queue A item 10) and come with it."""

    prompts: np.ndarray           # (k, s0) int32: identical prompt lengths
    rids: list[int]
    budgets: list[int]
    slots: list[int]              # reserved pool slots, one per request
    cache: dict | None = None     # (L, k, capacity, ...) device cache of the group
    frontend: torch.Tensor | None = None  # capacity-padded vlm frontend stub
    pos: int = 0                  # prompt tokens prefilled so far
    first: np.ndarray | None = None  # first emitted token per request (when done)

    @property
    def s0(self) -> int:
        return self.prompts.shape[1]

    @property
    def done(self) -> bool:
        return self.pos >= self.s0


# ---------------------------------------------------------------------------
# Workload-aware duty-cycle layer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServerStats:
    items: int = 0
    energy_j: float = 0.0
    busy_s: float = 0.0
    idle_s: float = 0.0
    reloads: int = 0
    missed: int = 0

    @property
    def items_per_joule(self) -> float:
        return self.items / self.energy_j if self.energy_j else 0.0


class WorkloadAwareServer:
    """Applies RQ2 strategies to a real engine over a request trace.

    Energy is modeled through the same ``AccelProfile``/``simulate`` path
    that reproduces the paper's C3/C4 (FPGA constants) — here with
    ``H100Chip``'s constants and the engine's *measured* per-batch latency.
    A learned threshold is trained on the engine's device.
    """

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        strategy: str = "adaptive",
        tau: float | None = None,
        chip: H100Chip = DEFAULT_CHIP,
        chips: int = 1,
        weight_bytes: float | None = None,
    ):
        self.engine = engine
        self.strategy = strategy
        self.chip = chip
        self.chips = chips
        self.weight_bytes = weight_bytes
        self.t_reload, self.e_reload = gpu_reload_costs(
            engine.cfg, chip, chips=chips, weight_bytes=weight_bytes
        )
        self.tau = tau
        self._measured_t: float | None = None

    def profile(self, t_inf_s: float) -> AccelProfile:
        return AccelProfile(
            t_inf_s=t_inf_s,
            p_active_w=self.chip.p_peak_w * self.chips,
            p_idle_w=self.chip.p_idle_w * self.chips,
            e_cfg_j=self.e_reload,
            t_cfg_s=self.t_reload,
        )

    def measure_latency(self, batch: int = 4, prompt_len: int = 16,
                        new_tokens: int = 8) -> float:
        """Wall seconds of one eager ``generate`` of ``batch`` zero prompts,
        after a warm-up call.  ``generate`` copies each step's tokens to the
        host, and that copy waits for the device, so the time covers the
        device work of every step and needs no other synchronisation."""
        prompts = np.zeros((batch, prompt_len), np.int32)
        self.engine.generate(prompts, 2)  # warm-up: first launches, tuner picks
        t0 = time.perf_counter()
        self.engine.generate(prompts, new_tokens)
        self._measured_t = time.perf_counter() - t0
        return self._measured_t

    def run_trace(
        self,
        gaps: np.ndarray,
        *,
        batch: int = 4,
        prompt_len: int = 16,
        new_tokens: int = 8,
        learn: bool = False,
        execute_every: int = 0,
        t_inf: float | None = None,
    ) -> ServerStats:
        """Serve one request batch per trace entry; ``gaps[i]`` is the idle
        time after batch i. ``execute_every=k`` really runs the engine every
        k-th batch (0 = once up front) — the rest reuse the measured latency
        (keeps CPU test time sane while the energy ledger stays faithful).
        ``t_inf`` overrides the measured batch latency (no engine run)."""
        if t_inf is None:
            t_inf = self._measured_t or self.measure_latency(batch, prompt_len, new_tokens)
        prof = self.profile(t_inf)
        tau = self.tau
        if self.strategy == "adaptive" and tau is None:
            tau = (learn_tau(gaps, prof, device=self.engine.device) if learn
                   else break_even_tau(prof))

        g = np.asarray(gaps, float).ravel()
        if execute_every:
            prompts = np.zeros((batch, prompt_len), np.int32)
            for _ in range(-(-g.size // execute_every)):
                self.engine.generate(prompts, new_tokens)

        # the whole energy ledger in ONE vectorized simulate call: simulate
        # already charges the single initial configuration plus per-gap energy
        res = simulate(g, self.strategy, prof, tau=tau)
        if self.strategy == "on_off":
            reloads = g.size
        elif self.strategy == "adaptive":
            reloads = int(np.count_nonzero(g > (tau or 0.0)))
        else:
            reloads = 0
        return ServerStats(
            items=res.items,
            energy_j=res.energy_j,
            busy_s=res.items * t_inf,
            idle_s=float(g.sum()),
            reloads=reloads,
            missed=res.missed_deadlines,
        )

    def compare_strategies(self, gaps: np.ndarray, *, t_inf: float | None = None,
                           **kw) -> dict[str, ServerStats]:
        """Run every strategy over ``gaps`` at one shared measured latency.

        The latency is passed to each per-strategy server explicitly —
        no private-attribute side channel, and ``self`` is left untouched
        when ``t_inf`` is supplied.  Each per-strategy server keeps this
        one's reload costs (its ``weight_bytes`` too, which the reference's
        ``compare_strategies`` does not pass on: there a server given
        measured weight bytes compares its strategies at the default
        2 bytes a parameter)."""
        if t_inf is None:
            t_inf = self._measured_t or self.measure_latency()
        out = {}
        for strat in ("on_off", "idle_waiting", "slow_down", "adaptive"):
            srv = WorkloadAwareServer(
                self.engine, strategy=strat, chip=self.chip, chips=self.chips,
                weight_bytes=self.weight_bytes,
            )
            out[strat] = srv.run_trace(gaps, t_inf=t_inf, **kw)
        return out
