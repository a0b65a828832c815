"""Serving engine: batched prefill → greedy decode, and the slot path of
continuous batching: ``make_pool`` → ``prefill_into_slot`` or chunked
prefill (``begin_chunked_prefill`` → ``chunked_prefill_step`` →
``finish_chunked_prefill``) → ``masked_decode_step`` or
``masked_speculative_step``, with ``poison_slot`` / ``resume_into_slot``
for quarantine and re-admission.

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
fault injection and the energy budget (item 11).  Without the paged pool,
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
import weakref

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
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
        "faults": (sc.faults is not None, "fault injection (ROADMAP Queue A item 11)"),
        "energy_budget_j": (sc.energy_budget_j is not None,
                            "the energy budget (ROADMAP Queue A item 11)"),
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
