"""Deterministic synthetic LM data pipeline (host-sharded, restart-replayable).

Sequences are drawn from a fixed random bigram chain (seeded at dataset
construction), so the data has learnable structure.  Every batch is a pure
function of ``(seed, step, host)``: after a failure and a restore, replaying
from the checkpointed step reproduces the exact token stream.  Tokens and
labels are the reference's (``repro.data.pipeline``) bit for bit: the same
numpy draws.

``frontend_embeds`` stubs (the vlm and audio families) are keyed the same
way, ``hash((seed, step, host, 1)) & 0x7FFFFFFF``, but drawn from a
``torch.Generator`` where the reference draws from a ``jax.random`` key, so
their numbers differ from the reference's; label positions covered by the
vlm's stub are masked with -1 (ignored by the masked CE).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Bigram-chain token source.

    Successors are CLASS-structured (token t's successor set depends on
    ``t % num_classes``): the optimal logit table then has rank ≤
    num_classes, so any model with d_model ≳ num_classes can reach the
    conditional-entropy floor (ln branching)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    branching: int = 4   # successors per class — entropy knob (~log2(b) bits)
    num_classes: int = 64  # rank of the optimal logit table

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a multiple of "
                             f"num_hosts {self.num_hosts}")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def _chain(self) -> np.ndarray:
        """(V, branching) successor table, fixed for the dataset's lifetime."""
        rng = np.random.default_rng(self.seed)
        k = min(self.num_classes, self.vocab_size)
        class_succ = rng.integers(0, self.vocab_size, size=(k, self.branching))
        classes = np.arange(self.vocab_size) % k
        return class_succ[classes]

    def batch(self, step: int, host: int = 0) -> dict:
        """Tokens and labels (numpy int32, (host_batch, seq_len)) for one host
        at one step.  Pure in (seed, step, host)."""
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} outside [0, {self.num_hosts})")
        chain = self._chain()
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, host, 0xDA7A]))
        b, s = self.host_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        draws = rng.integers(0, self.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = chain[toks[:, t], draws[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch(cfg: ArchConfig, ds: SyntheticLM, step: int, host: int = 0,
               device=None) -> dict:
    """Arch-aware batch of tensors on ``device`` (``None`` means the card):
    tokens and labels, plus the front-end stub and the vlm's label mask."""
    dev = resolve_device(device)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in ds.batch(step, host).items()}
    rows = {"vision": cfg.frontend_seq, "audio": cfg.encoder_seq}.get(cfg.frontend)
    if rows is not None:
        gen = torch.Generator().manual_seed(hash((ds.seed, step, host, 1)) & 0x7FFFFFFF)
        stub = torch.randn((ds.host_batch, rows, cfg.d_model), generator=gen)
        out["frontend_embeds"] = (0.02 * stub.to(cfg.dtype)).to(dev)
    if cfg.frontend == "vision":
        out["labels"][:, :cfg.frontend_seq] = -1
    return out


def unigram_entropy_bits(ds: SyntheticLM) -> float:
    """Entropy of the bigram chain's conditional (log2 branching) — the loss
    floor a perfect model reaches; the unconditional floor is log2(V)."""
    return math.log2(ds.branching)
