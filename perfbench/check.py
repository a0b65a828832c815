"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample drawn
from the seed of the requests the window finished, the longest among them,
is run through the configuration's plain reference: one whole forward pass
over each prompt and its served tokens.  The number compared is the widest
gap by which a served token's logit lies below the reference's best at its
position (greedy serving: 0 where the two agree).

The control puts the reference with int4 weights (the next precision below
the int8 the configuration states) in the program's place: at each position
of the same sequences, the gap under the int8 reference of the token the
int4 reference puts first.  Its gaps go through the same ``verdict`` as the
program's, and a sound limit makes it come out not correct.
"""
from __future__ import annotations

import numpy as np
import torch

INT4_LEVELS = 7


def sample(records, seed: int, *, min_tokens: int, max_requests: int) -> list:
    """Finished requests: the longest (prompt and served tokens), then
    others in an order drawn from ``seed`` until ``min_tokens`` served
    tokens or ``max_requests``."""
    done = [r for r in records if r.done and not r.failed and len(r.tokens) == r.budget]
    if not done:
        return []
    done.sort(key=lambda r: r.req.rid)
    longest = max(done, key=lambda r: (len(r.req.prompt) + len(r.tokens), -r.req.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(np.random.SeedSequence([int(seed), 0xC0DE])).permutation(len(rest))
    out, served = [longest], len(longest.tokens)
    for i in order:
        if served >= min_tokens or len(out) >= max_requests:
            break
        out.append(rest[i])
        served += len(rest[i].tokens)
    return out


def sequence(rec, device) -> tuple[torch.Tensor, int, torch.Tensor]:
    """(prompt + served tokens but the last, first position whose logits
    predict a served token, the served tokens)."""
    toks = np.concatenate([rec.req.prompt.astype(np.int64), np.asarray(rec.tokens[:-1], np.int64)])
    return (torch.as_tensor(toks, device=device), len(rec.req.prompt) - 1,
            torch.as_tensor(np.asarray(rec.tokens, np.int64), device=device))


def widest_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which the logit of ``tokens`` at each position lies
    below the reference's best there (0 where every token is the best)."""
    return float((ref.max(dim=-1).values - ref.gather(1, tokens[:, None])[:, 0]).max())


def gaps(model, weights, cfg, recs, device, weights4=None) -> tuple[list[float], list[float] | None]:
    """Each sampled request's widest gap of its served tokens under the
    reference; with ``weights4`` (the control) also the widest gap of the
    tokens that the int4 reference puts first at the same positions, else
    None."""
    program, control = [], ([] if weights4 is not None else None)
    for rec in recs:
        seq, first, served = sequence(rec, device)
        ref = model.reference_logits(weights, cfg, seq, first)
        program.append(widest_gap(ref, served))
        if weights4 is not None:
            low = model.reference_logits(weights4, cfg, seq, first).argmax(dim=-1)
            control.append(widest_gap(ref, low))
        del ref
    return program, control


def verdict(widest: list[float], failed: int, limit: float) -> bool:
    """``correct``: at least one request compared, each one's widest gap
    within ``limit``, and no request failed."""
    return bool(widest) and max(widest) <= limit and failed == 0
