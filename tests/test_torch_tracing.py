"""The port's tracer (``core/tracing.py``) and where the program uses it.

* Off, a span site records nothing; counters count whatever the state.
* Spans nest (``parent``), pass a request's ``rid`` to their children and
  carry the counters' deltas inside them; a recorded block diverts the
  counters and pauses the spans, a paused one pauses only the spans.
* Tracing is on while a torch profiler records, and a span mapped by
  ``to_unix_ns`` brackets the profiler's own event of the same interval.
* The launch counters of ``kernels/runtime.py`` are the tracer's
  ``launch.<kernel>`` counters; a replayed graph adds every counter its
  capture recorded.
* The engine's ticks count the cache rows decode attention scores and those
  of them that are live, by hand from the pool's positions; its prefill
  and chunk spans nest as documented.  The capture on the card is held by
  the last test, which needs the card and skips without one.
"""
import collections
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_reduced_config
from repro_torch.core import tracing
from repro_torch.kernels import runtime
from repro_torch.serving.engine import InferenceEngine, ServeConfig
from repro_torch.serving.graphs import StepGraph

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.stop()
    tracing.reset()
    yield
    tracing.stop()
    tracing.reset()


def _engine(arch: str, device="cpu", **sc):
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=torch.float32)
    return InferenceEngine(cfg, sc=ServeConfig(**sc), seed=0, device=device)


def _by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r.name].append(r)
    return out


def test_off_records_nothing_but_counts():
    assert not tracing.enabled()
    with tracing.span("tick", rid=3) as rec:
        tracing.count("c", 2)
    assert rec is None and tracing.spans() == []
    assert tracing.counter("c") == 2 and tracing.counters() == {"c": 2}
    # the same shared no-op at every site
    assert tracing.span("a") is tracing.span("b", rid=1)


def test_spans_nest_with_parents_rids_and_the_counter_deltas_inside_them():
    tracing.count("c", 10)
    tracing.start()
    with tracing.span("prefill", rid=7, tokens=3) as outer:
        tracing.count("c", 2)
        with tracing.span("prefill.forward") as inner:
            tracing.count("c", 5)
            tracing.count("d")
        with tracing.span("chunk", rids=[1, 2]) as other:
            pass
    tracing.stop()
    with tracing.span("after"):
        pass
    assert [r.name for r in tracing.spans()] == ["prefill.forward", "chunk", "prefill"]
    assert outer.parent is None and inner.parent == outer.id == other.parent
    assert outer.attrs == {"rid": 7, "tokens": 3}
    assert inner.attrs == {"rid": 7} and other.attrs == {"rids": [1, 2], "rid": 7}
    assert inner.counters == {"c": 5, "d": 1} and outer.counters == {"c": 7, "d": 1}
    assert other.counters == {}
    assert outer.t0 <= inner.t0 <= inner.t1 <= other.t0 <= other.t1 <= outer.t1


def test_a_recorded_block_diverts_the_counters_and_pauses_the_spans():
    tracing.start()
    with tracing.span("tick") as tick:
        tracing.count("c")
        with tracing.recorded() as rec:
            assert not tracing.enabled()
            tracing.count("c", 3)
            with tracing.span("inner"):
                tracing.count("e")
        assert tracing.enabled()
        with tracing.paused():
            assert not tracing.enabled()
            with tracing.span("inner"):
                tracing.count("e", 2)
    assert rec == {"c": 3, "e": 1}
    assert [r.name for r in tracing.spans()] == ["tick"]
    assert tick.counters == {"c": 1, "e": 2} and tracing.counters() == {"c": 1, "e": 2}


def test_storage_keeps_the_newest_spans_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    monkeypatch.setattr(tracing._state, "records", collections.deque(maxlen=3))
    tracing.start()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [r.name for r in tracing.spans()] == ["s2", "s3", "s4"]
    assert tracing.counter("tracing.dropped") == 2


def test_tracing_is_on_under_the_profiler_and_off_after_it():
    with tracing.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        with tracing.span("during"):
            pass
    assert not tracing.enabled()
    with tracing.span("after"):
        pass
    assert [r.name for r in tracing.spans()] == ["during"]


def test_a_mapped_span_brackets_the_profilers_event_within_a_millisecond():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer") as rec:
            with record_function("tracing.marker"):
                torch.ones(64).cumsum(0)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "tracing.marker"]
    assert len(events) == 1
    start, end = events[0].start_ns(), events[0].start_ns() + events[0].duration_ns()
    a, b = tracing.to_unix_ns(rec.t0), tracing.to_unix_ns(rec.t1)
    assert a - 1_000_000 <= start <= end <= b + 1_000_000
    assert b - a == rec.t1 - rec.t0


def test_launch_counters_are_the_tracers_launch_counters():
    runtime.reset_launch_counts()
    runtime.count_launch("k5", 2)
    tracing.count("attn.decode_calls")
    assert tracing.counter("launch.k5") == 2
    assert runtime.launch_counts() == {"k5": 2}
    runtime.reset_launch_counts()
    assert runtime.launch_counts() == {} and tracing.counters() == {"attn.decode_calls": 1}
    with runtime.launches_recorded() as rec:
        runtime.count_launch("k6", 3)
        tracing.count("attn.decode_calls", 5)
    assert rec == {"k6": 3} and tracing.counters() == {"attn.decode_calls": 1}


def test_a_replay_adds_every_counter_the_capture_recorded():
    cache = {"x": torch.zeros(3)}
    g = StepGraph(lambda cache, tok: {}, cache, {"tok": torch.zeros(2, dtype=torch.int64)}, 2, 0)
    assert g.counted == {} and g.launches == {}
    # what a capture leaves (serving/graphs.py), on a graph that replays nothing
    g.graph = types.SimpleNamespace(replay=lambda: None)
    g.counted = {"launch.int8_matmul": 3, "attn.decode_calls": 2, "attn.rows_scored": 40,
                 "graph.kernels": 9}
    g.replay()
    g.replay()
    assert tracing.counters() == {k: 2 * n for k, n in g.counted.items()}
    assert g.launches == {"int8_matmul": 3} and runtime.launch_counts() == {"int8_matmul": 6}
    assert g.replays == 2


def test_a_tick_counts_the_rows_it_scores_and_the_live_ones_from_the_positions():
    eng = _engine("granite-3-8b", max_batch=3, max_len=24)
    pool = eng.make_pool()
    eng.prefill_into_slot(pool, 0, np.arange(5, dtype=np.int32), rid=11, budget=6)
    eng.prefill_into_slot(pool, 2, np.arange(9, dtype=np.int32), rid=12, budget=6)
    pool.advance(2, 1, 4)
    capacity = pool.cache["k"].shape[2]
    layers = eng.cfg.num_layers
    tracing.start()
    eng.masked_decode_step(pool)
    tracing.stop()
    names = _by_name(tracing.spans())
    (tick,) = names["tick"]
    assert tick.counters == {"attn.decode_calls": layers,
                             "attn.rows_scored": layers * 3 * capacity,
                             "attn.rows_live": layers * ((5 + 1) + (10 + 1))}
    for child in ("tick.stage", "tick.replay", "tick.readback"):
        assert [r.parent for r in names[child]] == [tick.id]
    (replay,) = names["tick.replay"]
    assert replay.counters == {"attn.decode_calls": layers,
                               "attn.rows_scored": layers * 3 * capacity}
    # counters count with tracing off too
    before = tracing.counters()
    eng.masked_decode_step(pool)
    assert tracing.counter("attn.rows_scored") - before["attn.rows_scored"] == layers * 3 * capacity
    assert len(tracing.spans()) == sum(len(v) for v in names.values())


def test_prefill_spans_carry_the_request_to_their_children():
    eng = _engine("granite-moe-3b-a800m", max_batch=2, max_len=24)
    pool = eng.make_pool()
    tracing.start()
    eng.prefill_into_slot(pool, 1, np.arange(6, dtype=np.int32), rid=5, budget=4)
    tracing.stop()
    names = _by_name(tracing.spans())
    (pre,) = names["prefill"]
    assert pre.attrs == {"rid": 5, "tokens": 6} and pre.parent is None
    for child in ("prefill.forward", "prefill.grow", "prefill.first", "prefill.admit"):
        (c,) = names[child]
        assert c.parent == pre.id and c.attrs == {"rid": 5}
    assert sorted(names) == ["prefill", "prefill.admit", "prefill.first", "prefill.forward",
                             "prefill.grow"]


def test_chunk_spans_carry_the_group_and_its_position():
    eng = _engine("granite-3-8b", max_batch=3, max_len=24)
    pool = eng.make_pool()
    tracing.start()
    st = eng.begin_chunked_prefill(pool, [0, 1], np.arange(14, dtype=np.int32).reshape(2, 7),
                                   rids=[3, 4], budgets=[2, 2])
    while not st.done:
        eng.chunked_prefill_step(st, 4)
    eng.finish_chunked_prefill(pool, st)
    tracing.stop()
    names = _by_name(tracing.spans())
    assert [r.attrs for r in names["chunk"]] == [{"rids": [3, 4], "pos": 0, "tokens": 4},
                                                 {"rids": [3, 4], "pos": 4, "tokens": 3}]
    assert [r.parent for r in names["chunk.forward"]] == [r.id for r in names["chunk"]]
    assert [r.parent for r in names["chunk.first"]] == [names["chunk"][1].id]
    assert sorted(names) == ["chunk", "chunk.first", "chunk.forward"]


def test_the_capture_records_every_counter_and_the_graphs_kernels_on_the_card():
    """On the card the first tick warms up, captures and replays: the
    warm-up counts as an eager call does (no ``graph.kernels``), the
    capture records the launches, decode attention's counters and the
    graph's kernel nodes, and every tick (the first too) adds that record
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured and replayed on the card")
    cfg = dataclasses.replace(get_reduced_config("granite-3-8b"), dtype=torch.float32,
                              quant="int8")
    eng = InferenceEngine(cfg, sc=ServeConfig(max_batch=2, max_len=24), seed=0)
    pool = eng.make_pool()
    eng.prefill_into_slot(pool, 0, np.arange(5, dtype=np.int32), rid=0, budget=6)
    tracing.reset()
    tracing.start()
    eng.masked_decode_step(pool)
    pool.advance(0, 1, 3)
    eng.masked_decode_step(pool)
    tracing.stop()
    g = eng.step_graphs(pool)[("decode", 0)]
    layers, capacity = cfg.num_layers, pool.cache["k"].shape[2]
    assert g.counted["launch.int8_matmul"] == 7 * layers
    assert g.counted["attn.decode_calls"] == layers
    assert g.counted["attn.rows_scored"] == layers * 2 * capacity
    assert g.counted["graph.kernels"] > 7 * layers
    ticks = _by_name(tracing.spans())["tick"]
    warm = {k: 2 * n for k, n in g.counted.items() if k != "graph.kernels"}
    first = dict(g.counted, **warm, **{"attn.rows_live": 2 * layers * 6})
    assert [t.counters for t in ticks] == [first, dict(g.counted, **{"attn.rows_live": layers * 7})]
    assert {r.name for r in tracing.spans()} == {"tick", "tick.stage", "tick.replay",
                                                 "tick.readback"}
