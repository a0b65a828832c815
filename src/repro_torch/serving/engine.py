"""Serving engine: batched prefill → greedy decode, and the slot path of
continuous batching (``make_pool`` → ``prefill_into_slot`` →
``masked_decode_step``).

Ported so far: the contiguous engine of the dense family, in full precision
or with int8 weights (``ArchConfig.quant = "int8"``, every attention and MLP
projection through the ``int8_matmul`` kernel).  The options whose modules
are not ported raise ``NotImplementedError`` at construction: the paged
cache and int8 KV pages (ROADMAP Queue A item 10), fault injection and the
energy budget (item 11), speculative slack (item 9).  So do chunked
prefill, speculative verify and quarantine/resume (item 9).

How the JAX engine's idioms are expressed here:

* ``jit`` has no counterpart: the steps run eagerly, one kernel launch per
  quantized projection.
* ``donate_argnums`` becomes an in-place cache update.
* The masked decode step maps ``decode_step`` over the slots with ``vmap``
  in JAX, each slot a batch of one at its own position.  Here one batched
  call runs all slots, with a position per row: the same numbers, since
  each row's activation quantization and each output element depend only on
  that row; the int8 projections become one M = max_batch launch each.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import decode_step, init_model, prefill
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
        "spec_slack": (sc.spec_slack > 0, "speculative verify (ROADMAP Queue A item 9)"),
    }
    for name, (asked, what) in unported.items():
        if asked:
            raise NotImplementedError(f"ServeConfig.{name} needs {what}, not ported yet")
    if not sc.greedy:
        raise NotImplementedError("only greedy decoding exists, as in the JAX engine")


class InferenceEngine:
    """Batched prefill → decode loop (dense family)."""

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
        self.capacity = self.sc.max_len + self.sc.spec_slack

    def _frontend_stub(self, batch: int):
        cfg = self.cfg
        if cfg.frontend == "vision":
            return torch.zeros((batch, cfg.frontend_seq, cfg.d_model), dtype=cfg.dtype,
                               device=self.device)
        if cfg.frontend is not None:
            raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported yet "
                                      "(ROADMAP Queue A item 8)")
        return None

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
                  for inactive slots are garbage
          finite: (max_batch,) bool — False where the slot's logits hold
                  NaN/Inf; such a slot's token must not be committed.

        Inactive slots step at position 0: their writes land in dead rows
        that the next admit overwrites.  Host-side bookkeeping (advancing
        positions, retiring) is the caller's, as in the JAX engine.
        """
        active = torch.as_tensor(pool.decode_mask(), device=self.device)
        pos = torch.as_tensor(pool.positions().astype(np.int64), device=self.device)
        pos = torch.where(active, pos, torch.zeros_like(pos))
        tok = torch.as_tensor(pool.tok.astype(np.int64), device=self.device)[:, None]
        logits, pool.cache = decode_step(self.params, pool.cache, tok, pos, self.cfg)
        v = logits[:, : self.cfg.vocab_size]
        nxt = torch.argmax(v, dim=-1).to(torch.int32)
        fin = torch.isfinite(v).all(dim=-1)
        return nxt.cpu().numpy(), fin.cpu().numpy()
