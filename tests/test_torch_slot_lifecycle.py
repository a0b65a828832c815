"""The port's slot lifecycle and its captured ticks, on the CPU.

* ``SlotPool``: one seeded sequence of reserve / admit / activate / advance
  / retire on both packages' pools gives the same free-list order, masks,
  positions, ``committed`` and ``drafted`` after every operation, and the
  same cache rows.
* ``poison_slot`` → only that slot's ``finite`` is False → ``resume_into_slot``
  → the fault-free greedy continuation, as in the JAX engine, with and
  without int8 weights.
* ``serving/graphs.py`` on the CPU: the same step runs eagerly on static
  input buffers; a new cache gets a new graph.  Replay on the card is held
  to the eager step bit for bit by ``chip_smoke.py`` and by the last test
  here, which needs the card and skips without one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.serving.slots import SlotPool as JaxSlotPool
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.kernels import runtime
from repro_torch.serving.graphs import StepGraph, signature
from repro_torch.serving.slots import SlotPool

from test_torch_dense_serving import engines

torch.set_num_threads(1)


def test_slot_pool_lifecycle_matches_jax_step_for_step():
    jcfg = dataclasses.replace(jax_config("granite-3-8b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_config("granite-3-8b"), dtype=torch.float32)
    kw = dict(max_batch=4, max_len=20, slack=2)
    jp, tp = JaxSlotPool(jcfg, **kw), SlotPool(tcfg, device="cpu", **kw)
    rng = np.random.default_rng(31)
    shape = tuple(tp.cache["k"].shape)
    row_shape = (shape[0], 1, *shape[2:])

    def row():
        a = rng.standard_normal(row_shape).astype(np.float32)
        return {"k": a, "v": -a}

    def same():
        np.testing.assert_array_equal(tp.active, jp.active)
        np.testing.assert_array_equal(tp.admitting, jp.admitting)
        np.testing.assert_array_equal(tp.decode_mask(), jp.decode_mask())
        np.testing.assert_array_equal(tp.positions(), jp.positions())
        np.testing.assert_array_equal(tp.tok, jp.tok)
        assert tp.free_slots() == jp.free_slots() and tp.next_free() == jp.next_free()
        assert tp.active_slots() == jp.active_slots()
        assert tp.decoding_slots() == jp.decoding_slots()
        assert (tp.active_count, tp.free_count, tp.decoding_count) == \
            (jp.active_count, jp.free_count, jp.decoding_count)
        assert (tp.committed, tp.drafted) == (jp.committed, jp.drafted)
        assert tp.can_admit(4, 4) == jp.can_admit(4, 4)
        for k in ("k", "v"):
            np.testing.assert_array_equal(tp.cache[k].numpy(), np.asarray(jp.cache[k]))

    def both(name, *a, cache=None, **kw):
        if cache is None:
            getattr(tp, name)(*a, **kw)
            getattr(jp, name)(*a, **kw)
        else:
            getattr(tp, name)(*a, {k: torch.from_numpy(v) for k, v in cache.items()}, **kw)
            getattr(jp, name)(*a, {k: jnp.asarray(v) for k, v in cache.items()}, **kw)
        same()

    same()
    both("admit", 0, cache=row(), rid=10, pos=5, budget=6, first_tok=3)
    both("reserve", 1, rid=11)
    both("admit", 2, cache=row(), rid=12, pos=3, budget=8, first_tok=4)
    both("advance", 0, 1, 7)
    both("advance", 2, 3, 9)                                  # a verify tick: 2 drafts
    both("activate", 1, cache=row(), rid=11, pos=4, budget=5, first_tok=8)
    both("retire", 0)
    both("reserve", 3, rid=13)
    both("retire", 2)                                         # free list: 0, 2
    both("admit", 0, cache=row(), rid=14, pos=2, budget=3, first_tok=1)
    both("advance", 1, 2, 5)
    both("retire", 3)                                         # an admitting slot
    both("reserve", 2, rid=15)
    assert tp.free_slots() == [3]
    for op, args, kw in (("admit", (1, row()), dict(rid=0, pos=1, budget=2, first_tok=0)),
                         ("activate", (0, row()), dict(rid=14, pos=1, budget=2, first_tok=0)),
                         ("activate", (2, row()), dict(rid=99, pos=1, budget=2, first_tok=0)),
                         ("advance", (2, 1, 0), {}), ("retire", (3,), {})):
        if len(args) == 2 and isinstance(args[1], dict):
            args = (args[0], {k: torch.from_numpy(v) for k, v in args[1].items()})
        with pytest.raises(ValueError):
            getattr(tp, op)(*args, **kw)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_poison_then_resume_continues_the_fault_free_chain(quant):
    """A poisoned slot alone reads non-finite; re-admitted from its committed
    tokens it continues the uninterrupted greedy chain, as the JAX engine's
    does (``tests/test_faults.py``)."""
    je, te = engines("granite-3-8b", quant=quant, max_batch=2, max_len=48)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, te.cfg.vocab_size, 6).astype(np.int32)
    other = rng.integers(0, te.cfg.vocab_size, 4).astype(np.int32)
    ref = je.generate(prompt[None], 8)[0].tolist()
    runs = {}
    for name, eng in (("port", te), ("jax", je)):
        pool = eng.make_pool()
        toks = [eng.prefill_into_slot(pool, 0, prompt, rid=0, budget=8)]
        eng.prefill_into_slot(pool, 1, other, rid=1, budget=20)
        flags = []
        for _ in range(3):
            nxt, fin = eng.masked_decode_step(pool)
            assert fin.all()
            for s in (0, 1):
                pool.advance(s, 1, int(nxt[s]))
            toks.append(int(nxt[0]))
        eng.poison_slot(pool, 0)
        nxt, fin = eng.masked_decode_step(pool)
        flags.append(fin.tolist())
        assert not fin[0] and fin[1]  # only the poisoned slot
        pool.advance(1, 1, int(nxt[1]))
        pool.retire(0)
        context = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        eng.resume_into_slot(pool, 0, context, rid=0, budget=8, emitted=len(toks),
                             next_tok=toks[-1])
        while len(toks) < 8:
            nxt, fin = eng.masked_decode_step(pool)
            assert fin.all()
            for s in (0, 1):
                pool.advance(s, 1, int(nxt[s]))
            toks.append(int(nxt[0]))
        runs[name] = (toks, flags, pool.slots[1].pos, int(pool.tok[1]))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == ref
    with pytest.raises(ValueError, match="max_len"):
        te.resume_into_slot(te.make_pool(), 0, np.zeros(40, np.int32), rid=0, budget=20,
                            emitted=1, next_tok=0)


def test_step_graph_on_the_cpu_runs_the_step_on_its_static_buffers():
    calls = []

    def step(cache, tok, pos):
        calls.append((tok.data_ptr(), pos.data_ptr()))
        cache["x"][pos] += tok
        return {"sum": cache["x"].sum(dim=0, keepdim=True)}

    cache = {"x": torch.zeros(3, dtype=torch.int64)}
    inputs = {"tok": torch.zeros(2, dtype=torch.int64), "pos": torch.zeros(2, dtype=torch.int64)}
    g = StepGraph(step, cache, inputs, 2, 0)
    out = g(tok=np.asarray([5, 6], np.int32), pos=np.asarray([0, 2], np.int32))
    assert out["sum"].tolist() == [11] and cache["x"].tolist() == [5, 0, 6]
    assert inputs["tok"].tolist() == [5, 6] and inputs["tok"].dtype == torch.int64
    # the step always reads the same buffers, and nothing is captured or counted
    g(tok=np.asarray([1, 1]), pos=np.asarray([1, 1]))
    assert calls[0] == calls[1] == (inputs["tok"].data_ptr(), inputs["pos"].data_ptr())
    assert g.graph is None and g.replays == 0 and g.launches == {}
    copy = {"x": cache["x"].clone()}
    assert g.eager(copy)["sum"].tolist() == [13] and cache["x"].tolist() == [5, 1, 6]
    assert g.signature == signature(cache, 2, 0) != signature(copy, 2, 0)


def test_engine_keeps_one_graph_per_tick_kind_and_cache():
    _, te = engines("granite-3-8b", max_batch=2, max_len=24, spec_slack=2)
    pool = te.make_pool()
    prompt = np.arange(5, dtype=np.int32)
    te.prefill_into_slot(pool, 0, prompt, rid=0, budget=4)
    te.masked_decode_step(pool)
    te.masked_decode_step(pool)
    te.masked_speculative_step(pool, np.zeros((2, 2), np.int32))
    graphs = te.step_graphs(pool)
    assert sorted(graphs) == [("decode", 0), ("verify", 2)]
    g = graphs[("decode", 0)]
    assert g.inputs["pos"].tolist() == [5, 0] and g.inputs["active"].tolist() == [True, False]
    te.masked_decode_step(pool)
    assert te.step_graphs(pool)[("decode", 0)] is g
    # a rebound cache (which the pool never does) gets a graph of its own
    pool.cache = {k: v.clone() for k, v in pool.cache.items()}
    te.masked_decode_step(pool)
    assert te.step_graphs(pool)[("decode", 0)] is not g
    assert te.step_graphs(te.make_pool()) == {}


def test_launches_recorded_diverts_the_counters():
    runtime.reset_launch_counts()
    runtime.count_launch("k5")
    with runtime.launches_recorded() as rec:
        runtime.count_launch("k5", 3)
        runtime.count_launch("k6")
    assert rec == {"k5": 3, "k6": 1}
    assert runtime.launch_counts() == {"k5": 1}
    runtime.count_launch("k5", 3)
    assert runtime.launch_counts() == {"k5": 4}
    runtime.reset_launch_counts()


def test_replayed_tick_equals_the_eager_tick_on_the_card():
    """On a CUDA pool the decode and verify ticks are replayed graphs; their
    logits are the eager step's bit for bit, and each replay adds the
    captured launches to the counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured and replayed on the card")
    from repro_torch.serving.engine import InferenceEngine, ServeConfig

    cfg = dataclasses.replace(torch_config("granite-3-8b"), dtype=torch.float32, quant="int8")
    eng = InferenceEngine(cfg, sc=ServeConfig(max_batch=2, max_len=24, spec_slack=2), seed=0)
    pool = eng.make_pool()
    eng.prefill_into_slot(pool, 0, np.arange(5, dtype=np.int32), rid=0, budget=6)
    for kind, tick in (("decode", lambda: eng.masked_decode_step(pool)),
                       ("verify", lambda: eng.masked_speculative_step(
                           pool, np.zeros((2, 2), np.int32)))):
        tick()
        g = eng.step_graphs(pool)[(kind, 2 if kind == "verify" else 0)]
        copy = {k: v.clone() for k, v in pool.cache.items()}
        runtime.reset_launch_counts()
        replayed = g.replay()["logits"].clone()
        assert runtime.launch_counts() == g.launches
        assert g.launches["int8_matmul"] == 7 * cfg.num_layers
        eager = g.eager(copy)["logits"]
        assert torch.equal(replayed.view(torch.int32), eager.view(torch.int32))
        for k in copy:
            assert torch.equal(copy[k], pool.cache[k])
