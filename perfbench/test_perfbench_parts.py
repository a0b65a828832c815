"""CPU tests of the benchmark's parts: the traffic generator, the counts of
operations and bytes on the port's reduced configs, the plain reference
against the port at tiny size, the trace summary and the loop's policy."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import counts, program, run, traffic
from perfbench.models import gqa_lm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CONFIGS = ["granite-3-8b-int8-8L", "granite-moe-3b-a800m-int8"]


def _cfg(name: str, rehearsal: bool = True):
    cfg = run.load_json(ROOT / "perfbench" / "configs" / f"{name}.json")
    arch = program.arch_config(cfg, gqa_lm, rehearsal=rehearsal)
    return (gqa_lm.rehearsal_config(cfg, arch) if rehearsal else cfg), arch


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mix", ["chat", "batch", "longdoc"])
def test_every_seed_serves_the_same_lengths_in_another_order(mix):
    t = run.load_json(ROOT / "perfbench" / "traffic" / f"{mix}.json")
    a = traffic.make_requests(t, seed=2**31 + 11, seconds=45, vocab_size=1000)
    b = traffic.make_requests(t, seed=5, seconds=45, vocab_size=1000)
    again = traffic.make_requests(t, seed=5, seconds=45, vocab_size=1000)
    key = [(len(r.prompt), r.new_tokens) for r in a]
    block = t["shuffle_block"]
    assert sorted(key) == sorted((len(r.prompt), r.new_tokens) for r in b)
    # a mix with blocks of one keeps its own order: the seed draws the tokens only
    assert (key != [(len(r.prompt), r.new_tokens) for r in b]) == (block > 1)
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(b, again))
    for i in range(0, len(a), block):  # the same lengths in every block
        assert sorted(key[i:i + block]) == sorted(
            (len(r.prompt), r.new_tokens) for r in b[i:i + block])
    for spec, vals in ((t["prompt"], [len(r.prompt) for r in a]),
                       (t["output"], [r.new_tokens for r in a])):
        assert spec["min"] <= min(vals) and max(vals) <= spec["max"]
    assert all(r.prompt.max() < 1000 for r in a)
    if t["loop"] == "open":
        due = [r.arrival_s for r in a]
        assert due == sorted(due) and due[0] == -t["ramp_s"] and due[-1] < 45
        assert len(a) == round(t["rate_hz"] * (t["ramp_s"] + 45))
    else:
        assert all(r.arrival_s is None for r in a) and len(a) == t["requests"]


def test_lognormal_lengths_have_the_stated_median():
    x = traffic.draw_lengths(np.random.default_rng(0), {"dist": "lognormal", "median": 256,
                                                        "sigma": 0.8, "min": 1, "max": 10**6},
                             20000)
    assert abs(np.median(x) - 256) < 8


def test_primed_budgets_are_staggered():
    t = {"prime": "staggered"}
    assert [traffic.primed_budget(t, j, 4, 100) for j in range(4)] == [25, 50, 75, 100]
    assert traffic.primed_budget({}, 0, 4, 100) == 100


def test_block_permutation_stays_in_its_blocks():
    p = traffic.block_permutation(np.random.default_rng(1), 21, 8)
    assert sorted(p) == list(range(21))
    assert all(i // 8 == v // 8 for i, v in enumerate(p))


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_k5_calls_are_the_port_projections(name):
    """7 launches a layer, each of a projection's (k, n) and the expert
    count, against the port's own parameter shapes."""
    from repro_torch.models.model import param_defs

    cfg, arch = _cfg(name)
    s = gqa_lm.sizes(cfg)
    calls = gqa_lm.k5_calls(s, 5)
    assert len(calls) == 7 * s.layers
    defs = param_defs(arch)["blocks"]
    ffn = defs["moe"] if s.moe else defs["mlp"]
    want = []
    for key in ("wq", "wk", "wv", "wo"):
        shape = defs["attn"][key].shape[1:]
        c = 2 if key == "wo" else 1
        want.append((5, math.prod(shape[:c]), math.prod(shape[c:]), 1))
    for key in ("wg", "wu", "wd"):
        shape = ffn[key].shape[1:]
        want.append((5, shape[1], shape[2], shape[0]) if s.moe else (5, shape[0], shape[1], 1))
    assert [c[:4] for c in calls[:7]] == want
    assert [c[4] for c in calls[:7]] == [False] * 4 + ([True, True, False] if s.moe else [False] * 3)


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_bytes_are_the_served_projection_bytes(name):
    """The bytes a step reads: every int8 payload and f32 scale the port
    holds (the real experts only), the LM head's real columns, the norms
    and the router."""
    cfg, arch = _cfg(name)
    s = gqa_lm.sizes(cfg)
    w = gqa_lm.make_weights(cfg, 3, "cpu")
    total = 0
    for pname, *_ in gqa_lm.projections(s):
        q, sc = w[pname]
        if s.moe and pname in ("wg", "wu", "wd"):
            q, sc = q[:, : s.experts], sc[:, : s.experts]
        total += q.numel() + 4 * sc.numel()
    total += 2 * s.d * s.vocab + 4 * (w["ln1"].numel() + w["ln2"].numel() + w["final_norm"].numel())
    if s.moe:
        total += 4 * s.layers * s.d * s.experts
    assert gqa_lm.weight_bytes(s) == total


def test_work_counts_add_up():
    cfg, _ = _cfg("granite-3-8b-int8-8L", rehearsal=False)
    s = gqa_lm.sizes(cfg)
    per_tok = 2 * gqa_lm.matmul_params_per_token(s) * s.layers
    head = 2 * s.d * s.vocab
    # a prefill of 3 tokens attends over 1 + 2 + 3 positions
    attn = 4 * s.heads * s.head_dim * 6 * s.layers
    assert gqa_lm.work_ops(s, "prefill", tokens=3) == 3 * per_tok + attn + head
    # a tick over slots at positions 9 and 0 reads 10 and 1 rows
    assert gqa_lm.work_ops(s, "tick", positions=[9, 0]) == (
        2 * (per_tok + head) + 4 * s.heads * s.head_dim * 11 * s.layers)
    assert gqa_lm.work_bytes(s, "tick", positions=[9, 0]) == (
        gqa_lm.weight_bytes(s) + 11 * gqa_lm.kv_row_bytes(s))
    assert gqa_lm.kv_row_bytes(s) == 8 * 2 * 8 * 128 * 2
    # a chunk of 4 at position 8 for 2 rows: contexts 9..12, the head only on the last chunk
    one = 4 * per_tok + 4 * s.heads * s.head_dim * (9 + 10 + 11 + 12) * s.layers
    assert gqa_lm.work_ops(s, "chunk", rows=2, pos=8, tokens=4, last=False) == 2 * one
    assert gqa_lm.work_ops(s, "chunk", rows=2, pos=8, tokens=4, last=True) == 2 * one + 2 * head
    # granite-3-8b's 8 layers: 1.54e9 matmul params a token (wq, wk, wv, wo, MLP)
    assert gqa_lm.matmul_params_per_token(s) == 4096 * 4096 * 2 + 2 * 4096 * 1024 + 3 * 4096 * 12800


def test_k5_bound_counts_each_operand_once():
    m, k, n = 32, 4096, 12800
    nbytes = m * (k + 4) + k * n + 4 * n + 4 * m * n
    assert counts.k5_call_bound_s(m, k, n, 1, False) == pytest.approx(nbytes / 3.35e12)
    shared = counts.k5_call_bound_s(4, 1536, 512, 48, True)
    stacked = counts.k5_call_bound_s(4, 1536, 512, 48, False)
    assert stacked - shared == pytest.approx(47 * 4 * (1536 + 4) / 3.35e12)
    big = 4096
    assert counts.k5_call_bound_s(big, big, big, 1, False) == pytest.approx(2 * big**3 / 1979e12)


# ---------------------------------------------------------------------------
# the plain reference against the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_prefill_at_tiny_size(name):
    from repro_torch.models.model import prefill

    cfg, arch = _cfg(name)
    cfg = dict(cfg, num_hidden_layers=arch.num_layers)
    w = gqa_lm.make_weights(cfg, 21, "cpu")
    params = program.program_params(w, cfg, arch, gqa_lm)
    toks = torch.randint(0, arch.vocab_size, (9,), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        got = prefill(params, toks[None], arch)[0][0, : arch.vocab_size].float()
    ref = gqa_lm.reference_logits(w, cfg, toks, 8)[0]
    scale = ref.abs().max()
    assert (got - ref).abs().max() / scale < 0.05
    assert int(got.argmax()) == int(ref.argmax()) or (ref.max() - ref[got.argmax()]) < 0.05 * scale
    # the same reference in int4 weights is far off: the control's precision
    w4 = gqa_lm.make_weights(cfg, 21, "cpu", levels=7)
    low = gqa_lm.reference_logits(w4, cfg, toks, 8)[0]
    assert (low - ref).abs().max() > 2 * (got - ref).abs().max()


def test_int4_draws_the_same_weights_on_a_coarser_grid():
    cfg, _ = _cfg("granite-3-8b-int8-8L")
    w8 = gqa_lm.make_weights(cfg, 4, "cpu")
    w4 = gqa_lm.make_weights(cfg, 4, "cpu", levels=7)
    assert torch.equal(w8["embed"], w4["embed"])
    q8, s8 = w8["wq"]
    q4, s4 = w4["wq"]
    assert q4.abs().max() <= 7 and torch.allclose(s4 * 7, s8 * 127)


# ---------------------------------------------------------------------------
# the trace summary
# ---------------------------------------------------------------------------
def test_union_merges_overlapping_intervals():
    from perfbench.profiling import _union

    assert _union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [(0, 3), (5, 10)]


def test_percentile_is_linear_between_order_statistics():
    from perfbench.stats import percentile

    assert percentile(list(range(11)), 90) == 9
    assert percentile([1.0, 2.0], 50) == 1.5
    assert percentile([], 90) is None


# ---------------------------------------------------------------------------
# the loop's policy, on a fake engine
# ---------------------------------------------------------------------------
class _FakeEngine:
    """Prefill and chunks that record their order, and a tick whose token
    is the slot's position: enough to watch admission and retirement."""

    def __init__(self, calls):
        self.calls = calls

    def prefill_into_slot(self, pool, slot, prompt, *, rid, budget):
        self.calls.append(("prefill", rid))
        pool.admit(slot, None, rid=rid, pos=len(prompt), budget=budget, first_tok=0)
        return 0

    def masked_decode_step(self, pool):
        self.calls.append(("tick", pool.decoding_count))
        nxt = np.array([s.pos for s in pool.slots], np.int32)
        return nxt, np.ones(pool.max_batch, bool)

    def begin_chunked_prefill(self, pool, slots, prompts, *, rids, budgets):
        for slot, rid in zip(slots, rids):
            pool.reserve(slot, rid=rid)
        return type("St", (), {"pos": 0, "s0": prompts.shape[1], "slots": slots, "rids": rids,
                               "budgets": budgets, "done": False})()

    def chunked_prefill_step(self, st, chunk):
        self.calls.append(("chunk", st.rids[0]))
        st.pos = min(st.s0, st.pos + chunk)
        st.done = st.pos >= st.s0
        return chunk

    def finish_chunked_prefill(self, pool, st):
        for slot, rid, b in zip(st.slots, st.rids, st.budgets):
            pool.activate(slot, None, rid=rid, pos=st.s0, budget=b, first_tok=0)
        return np.zeros(len(st.slots), np.int32)


class _Pool:
    """The port's slot bookkeeping without a cache."""

    def __new__(cls, max_batch, max_len):
        from repro_torch.configs import get_reduced_config
        from repro_torch.serving.slots import SlotPool

        pool = SlotPool(get_reduced_config("granite-3-8b"), max_batch=max_batch,
                        max_len=max_len, virtual=True, device="cpu")
        pool._write = lambda slot, cache: None
        pool.cache = {}
        return pool


def _requests(lengths, budgets):
    return [traffic.Request(i, None, np.zeros(n, np.int32), b)
            for i, (n, b) in enumerate(zip(lengths, budgets))]


def test_blocking_loop_admits_fifo_and_retires_at_the_budget():
    from perfbench.loop import ServeLoop

    calls = []
    t = {"loop": "closed", "clients": 3, "admission": {"mode": "blocking"}}
    loop = ServeLoop(_FakeEngine(calls), _Pool(2, 64), t, _requests([4, 5, 6, 7, 8], [3, 2, 4, 1, 2]))
    loop.start(0.0)
    loop.open_clients(0.0, 0)
    while loop.iteration():
        pass
    recs = loop.records
    assert sorted(recs) == [0, 1, 2, 3, 4]
    assert all(r.done and len(r.tokens) == r.budget for r in recs.values())
    # the first two fill the pool; the third waits for a free slot, FIFO
    assert [c for c in calls if c[0] == "prefill"][:3] == [("prefill", 0), ("prefill", 1),
                                                            ("prefill", 2)]
    assert calls.index(("prefill", 2)) > calls.index(("tick", 2))
    # decode tokens are the slot's position as it stood: prompt, then +1 a tick
    assert recs[0].tokens == [0, 4, 5]


def test_chunked_loop_runs_one_chunk_between_ticks():
    from perfbench.loop import ServeLoop

    calls = []
    t = {"loop": "closed", "clients": 2, "admission": {"mode": "chunked", "chunk_tokens": 4}}
    loop = ServeLoop(_FakeEngine(calls), _Pool(2, 64), t, _requests([4, 12], [6, 2]))
    loop.start(0.0)
    loop.open_clients(0.0, 0)
    while loop.iteration():
        pass
    # request 0's one chunk, then request 1's three chunks, each followed
    # by a tick of the slots that decode
    assert calls == [("chunk", 0), ("tick", 1), ("chunk", 1), ("tick", 1), ("chunk", 1),
                     ("tick", 1), ("chunk", 1), ("tick", 2), ("tick", 1)]
    assert all(r.done and len(r.tokens) == r.budget for r in loop.records.values())
