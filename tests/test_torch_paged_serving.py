"""The port's paged serving on the CPU, on the reduced f32 configs of the
five cache layouts: GQA (granite-3-8b), MLA (deepseek-v3-671b), pure SSM
(mamba2-780m: nothing paged), hybrid (zamba2-7b: its shared-attention K/V
paged, conv/state per slot) and audio (whisper-tiny: its self-attention K/V
paged, the cross K/V per slot).

* the port's paged engine gives its contiguous engine's tokens, over one
  fixed script of ``prefill_into_slot``, ``masked_decode_step``, retire and
  re-admission;
* the same script on the JAX paged engine and the port's: the same tokens
  and tables after every tick, page leaves (all but the scratch page, whose
  bytes are whichever duplicate write landed last) within 2e-5 of their
  largest magnitude;
* chunked prefill and verify with K = 3 (granite, zamba2) on the paged
  pool, which has no ``spec_slack`` rows, against the contiguous pool;
* poison and resume of a slot that shares prefix pages, whose sharers'
  bytes stay as they were;
* a shared prefix: the same tokens in fewer chunk steps, and the JAX
  engine's ``shared_hit_pages``;
* ``kv_quant="int8"``: tokens identical to the JAX engine's, and after the
  same script the scales within 2e-5 and the payloads equal but at a few
  rounding edges, there one step apart.  The K/V rows the two packages
  quantize differ in their last f32 bits (the scales within one ulp when the
  rows are the same: ``test_torch_pages``), so a quotient within that of a
  half-way point rounds either way: 1 of zamba2's 30720 payloads, none of
  granite's 10240.

The reference's scheduler-driven paged tests are mirrored by
``test_torch_scheduler_paged``, ``test_torch_scheduler_paged_modes`` and
``test_torch_preemption*``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models.model import param_defs as jax_param_defs
from repro.serving.engine import InferenceEngine as JaxEngine, ServeConfig as JaxServeConfig
from repro_torch.configs import get_reduced_config as torch_config
from repro_torch.kernels import runtime
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import InferenceEngine, ServeConfig
from repro_torch.serving.kv_cache import paged_cache_bytes
from repro_torch.serving.pages import SCRATCH, PagedSlotPool

from test_torch_audio import weights as audio_weights
from test_torch_moe import numpy_params

torch.set_num_threads(1)
FAMILY_ARCHS = ("granite-3-8b", "deepseek-v3-671b", "mamba2-780m", "zamba2-7b", "whisper-tiny")
MAX_BATCH, MAX_LEN, PAGE, K = 2, 32, 4, 3
TOL = 2e-5


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    """(JAX config, JAX params, port config, port params) over the same f32
    weights; whisper's are ``test_torch_audio``'s (its embedding at std 1)."""
    if arch == "whisper-tiny":
        return audio_weights()
    jcfg = dataclasses.replace(jax_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_config(arch), dtype=torch.float32)
    jp = numpy_params(jax_param_defs(jcfg), np.random.default_rng(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def port_engine(arch: str, **sc):
    _, _, tcfg, tp = weights(arch)
    return InferenceEngine(tcfg, params=tp, sc=ServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN,
                                                           **sc), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_engine(arch: str, **sc):
    jcfg, jp, _, _ = weights(arch)
    return JaxEngine(jcfg, params=jp, sc=JaxServeConfig(max_batch=MAX_BATCH, max_len=MAX_LEN,
                                                        **sc))


PAGED = dict(paged=True, page_size=PAGE)


def prompt(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def decode_ticks(eng, pool, chains: dict, ticks: int, on_tick=None) -> None:
    """``ticks`` masked decode ticks; each decoding slot's token is committed
    to its request's chain (by rid), and a slot at its budget retires."""
    for _ in range(ticks):
        live = pool.decode_mask().copy()
        nxt, fin = eng.masked_decode_step(pool)
        assert fin[live].all()
        for s in map(int, np.flatnonzero(live)):
            pool.advance(s, 1, int(nxt[s]))
            chains[pool.slots[s].rid].append(int(nxt[s]))
            if pool.slots[s].emitted >= pool.slots[s].budget:
                pool.retire(s)
        if on_tick is not None:
            on_tick(pool)


def script(eng, on_tick=None) -> dict:
    """Two slots admitted, four ticks, one retired early and its slot given
    a new request, five more ticks (the other request retires at its
    budget on the way).  Returns the chains by rid."""
    pool = eng.make_pool()
    chains = {0: [eng.prefill_into_slot(pool, 0, prompt(1, 5), rid=0, budget=10)],
              1: [eng.prefill_into_slot(pool, 1, prompt(2, 9), rid=1, budget=6)]}
    decode_ticks(eng, pool, chains, 4, on_tick)
    pool.retire(0)
    chains[2] = [eng.prefill_into_slot(pool, 0, prompt(3, 7), rid=2, budget=8)]
    decode_ticks(eng, pool, chains, 5, on_tick)
    return chains


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_paged_engine_is_token_identical_to_contiguous(arch):
    paged = port_engine(arch, **PAGED)
    assert script(paged) == script(port_engine(arch))
    pool = paged.make_pool()
    assert isinstance(pool, PagedSlotPool) and pool.cache is not None
    assert pool.virtual_len == pool.max_blocks * PAGE == 40  # ceil((32 + 4) / 4) + 1 blocks


def page_leaves_close(tp, jp) -> None:
    """Every leaf of the two pools' caches within ``TOL`` of its largest
    magnitude; paged leaves without the scratch page."""
    for key, leaf in tp.cache.items():
        got, want = leaf.numpy(), np.asarray(jp.cache[key])
        if key in tp._pleaves:
            got, want = got[:, SCRATCH + 1:], want[:, SCRATCH + 1:]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=key)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_paged_engine_matches_the_jax_paged_engine(arch):
    tables = {"port": [], "jax": []}
    pools = {}

    def recorder(name):
        def on_tick(pool):
            tables[name].append(pool.table.copy())
            pools[name] = pool
        return on_tick

    got = script(port_engine(arch, **PAGED), recorder("port"))
    want = script(jax_engine(arch, **PAGED), recorder("jax"))
    assert got == want
    assert len(tables["port"]) == len(tables["jax"]) == 9
    for t, j in zip(tables["port"], tables["jax"]):
        np.testing.assert_array_equal(t, j)
    page_leaves_close(pools["port"], pools["jax"])


@pytest.mark.parametrize("arch", ("granite-3-8b", "zamba2-7b"))
def test_paged_chunked_prefill_and_verify_match_the_contiguous_pool(arch):
    """A group of two 9-token prompts chunk-prefilled 4 tokens at a time
    while a slot decodes, then verify ticks of K = 3: slot 0's drafts its
    own plain chain (accepting all), slot 1's always wrong (accepting
    none).  The paged pool (no ``spec_slack``) gives the contiguous pool's
    (``spec_slack`` = K) tokens and accepted counts, and its verify tails
    land on pages it allocated on demand."""
    runs = {}
    for name, sc in (("contiguous", dict(spec_slack=K)), ("paged", PAGED)):
        _, _, tcfg, tp = weights(arch)
        eng = InferenceEngine(tcfg, params=tp, sc=ServeConfig(max_batch=3, max_len=MAX_LEN, **sc),
                              device="cpu")
        pool = eng.make_pool()
        chains = {2: [eng.prefill_into_slot(pool, 2, prompt(4, 6), rid=2, budget=20)]}
        group = np.stack([prompt(5, 9), prompt(6, 9)])
        st = eng.begin_chunked_prefill(pool, [0, 1], group, rids=[0, 1], budgets=[12, 12])
        steps = 0
        while not st.done:
            eng.chunked_prefill_step(st, 4)
            decode_ticks(eng, pool, chains, 1)
            steps += 1
        chains.update({j: [int(t)] for j, t in enumerate(eng.finish_chunked_prefill(pool, st))})
        # slot 0's plain chain, from a copy of the engine state
        plain = {0: list(chains[0])}
        twin = eng.make_pool()
        twin_first = eng.prefill_into_slot(twin, 0, group[0], rid=0, budget=12)
        assert twin_first == chains[0][0]
        decode_ticks(eng, twin, plain, 8)
        verified = []
        while len(chains[0]) < 9:
            e = len(chains[0])
            drafts = np.zeros((3, K), np.int32)
            drafts[0] = (plain[0][e:e + K] + [0] * K)[:K]
            drafts[1] = (np.asarray(chains[1][-1:] * K) + 1 + np.arange(K)) % tcfg.vocab_size
            drafts[2] = drafts[1]
            toks, acc, fin = eng.masked_speculative_step(pool, drafts)
            live = pool.decode_mask()
            assert fin[live].all() and acc[1] == 0
            verified.append((toks[:2].tolist(), acc[:2].tolist()))
            for s in map(int, np.flatnonzero(live)):
                a = int(acc[s])
                pool.advance(s, a + 1, int(toks[s, a]))
                chains[pool.slots[s].rid].extend(toks[s, :a + 1].tolist())
        if isinstance(pool, PagedSlotPool):
            pool.check_invariants()
            assert pool.slack == 0
        runs[name] = (chains, plain, verified, steps)
    assert runs["paged"] == runs["contiguous"]
    chains, plain, verified, _ = runs["paged"]
    assert chains[0][:9] == plain[0][:9] and any(a[0] == K for _, a in verified)


def test_poison_and_resume_leave_shared_pages_as_they_were():
    """Slot 0 admits a prompt whose full blocks are registered; slot 1's
    chunked prefill maps two of them.  Poisoning slot 1 copies the shared
    pages before it writes NaN: slot 0 and the registry keep their bytes,
    slot 0's next tick is finite and its chain the fault-free one, the
    scratch page is zeroed after the flagged tick, and slot 1 resumed from
    its committed tokens continues its fault-free chain."""
    eng = port_engine("granite-3-8b", share_prefix=True, **PAGED)
    base = prompt(7, 13)
    other = np.concatenate([base[:8], prompt(8, 5)])

    def run(poison: bool):
        pool = eng.make_pool()
        chains = {0: [eng.prefill_into_slot(pool, 0, base, rid=0, budget=10)]}
        st = eng.begin_chunked_prefill(pool, [1], other[None], rids=[1], budgets=[10])
        assert st.shared_len == 8 and st.pos == 8 and len(st.pins[0]) == 2
        while not st.done:
            eng.chunked_prefill_step(st, 4)
        chains[1] = [int(eng.finish_chunked_prefill(pool, st)[0])]
        shared = [int(p) for p in pool.table[1, :2]]
        assert shared == [int(p) for p in pool.table[0, :2]]
        decode_ticks(eng, pool, chains, 2)
        if poison:
            before = {k: pool.cache[k][:, shared].clone() for k in pool._pleaves}
            eng.poison_slot(pool, 1)
            pool.check_invariants()
            assert [int(p) for p in pool.table[1, :2]] != shared
            for k, v in before.items():
                assert torch.equal(pool.cache[k][:, shared], v)
            live = pool.decode_mask().copy()
            nxt, fin = eng.masked_decode_step(pool)
            assert fin.tolist() == [True, False] and live.all()
            for k in pool._pleaves:
                assert not pool.cache[k][:, SCRATCH].any()  # scrubbed
            pool.advance(0, 1, int(nxt[0]))
            chains[0].append(int(nxt[0]))
            pool.retire(1)
            context = np.concatenate([other, np.asarray(chains[1][:-1], np.int32)])
            eng.resume_into_slot(pool, 1, context, rid=1, budget=10, emitted=len(chains[1]),
                                 next_tok=chains[1][-1])
        decode_ticks(eng, pool, chains, 10)
        pool.check_invariants()
        return chains

    clean, faulted = run(False), run(True)
    assert faulted[0] == clean[0]
    # the resumed request re-prefills its context: the same tokens
    assert faulted[1] == clean[1]


def shared_prefix_run(eng) -> tuple[dict, int, int]:
    """A 13-token prompt admitted blocking (its three full blocks
    registered where prefix sharing is on), then a group of two prompts that
    share its first 12 tokens, chunk-prefilled 2 tokens at a time, and 6
    ticks.  Returns (chains by rid, chunk steps, shared_hit_pages)."""
    base = prompt(9, 13)
    pool = eng.make_pool()
    chains = {0: [eng.prefill_into_slot(pool, 0, base, rid=0, budget=8)]}
    pool.retire(0)  # the registry keeps its pages
    group = np.stack([np.concatenate([base[:12], prompt(10, 2)]),
                      np.concatenate([base[:12], prompt(11, 2)])])
    st = eng.begin_chunked_prefill(pool, [0, 1], group, rids=[1, 2], budgets=[8, 8])
    steps = 0
    while not st.done:
        eng.chunked_prefill_step(st, 2)
        steps += 1
    first = eng.finish_chunked_prefill(pool, st)
    chains.update({1: [int(first[0])], 2: [int(first[1])]})
    decode_ticks(eng, pool, chains, 6)
    return chains, steps, getattr(pool, "shared_hit_pages", 0)


def test_shared_prefix_gives_the_same_tokens_in_fewer_chunk_steps():
    shared = shared_prefix_run(port_engine("granite-3-8b", share_prefix=True, **PAGED))
    unshared = shared_prefix_run(port_engine("granite-3-8b", **PAGED))
    contiguous = shared_prefix_run(port_engine("granite-3-8b"))
    assert shared[0] == unshared[0] == contiguous[0]
    assert (shared[1], unshared[1], contiguous[1]) == (1, 7, 7)  # 2 of 14 tokens, not 14
    assert (shared[2], unshared[2]) == (6, 0)  # 3 pages for each of the two
    want = shared_prefix_run(jax_engine("granite-3-8b", share_prefix=True, **PAGED))
    assert shared == want


@pytest.mark.parametrize("arch", ("granite-3-8b", "zamba2-7b"))
def test_int8_kv_pages_match_the_jax_pool(arch):
    pools = {}

    def keep(name):
        def on_tick(pool):
            pools[name] = pool
        return on_tick

    q = dict(kv_quant="int8", **PAGED)
    got = script(port_engine(arch, **q), keep("port"))
    want = script(jax_engine(arch, **q), keep("jax"))
    assert got == want
    tp, jp = pools["port"], pools["jax"]
    assert set(tp._skeys) == {f"{k}_scale" for k in tp._pkeys} and tp._skeys
    np.testing.assert_array_equal(tp.table, jp.table)
    for key in tp._pleaves:
        got = tp.cache[key].numpy()[:, SCRATCH + 1:]
        want = np.asarray(jp.cache[key])[:, SCRATCH + 1:]
        if key in tp._skeys:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=0, err_msg=key)
        else:
            assert got.dtype == np.int8
            steps = np.abs(got.astype(np.int32) - want)
            assert steps.max() <= 1 and (steps > 0).mean() <= 1e-3, (key, np.bincount(
                steps.ravel()))


def test_paged_options_build_and_the_scheduler_options_still_raise():
    _, _, tcfg, tp = weights("granite-3-8b")
    eng = InferenceEngine(tcfg, params=tp, sc=ServeConfig(
        max_batch=2, max_len=16, paged=True, share_prefix=True, kv_quant="int8", page_size=4),
        device="cpu")
    pool = eng.make_pool()
    assert pool.share_prefix and pool.kv_quant == "int8"
    nbytes = sum(v.nbytes for v in pool.cache.values()) + pool.table.nbytes
    assert nbytes == paged_cache_bytes(tcfg, batch=2, num_pages=pool.num_pages, page_size=4,
                                       max_blocks=pool.max_blocks, kv_quant="int8")
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine(tcfg, params=tp, sc=ServeConfig(kv_quant="int8"), device="cpu").make_pool()
    # the scheduler's options, once refused, build on a paged engine too, and
    # a scheduler over it reads them: the profile's NaN faults are quarantined
    # on pages, the budget bounds every window
    from repro_torch.serving.faults import FaultProfile
    from repro_torch.serving.load import poisson_stream
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler, FixedCalibration

    prof = FaultProfile(seed=7, nan_rate=0.3, max_faults=3)
    eng = InferenceEngine(tcfg, params=tp, device="cpu", sc=ServeConfig(
        max_batch=2, max_len=16, paged=True, page_size=4, faults=prof, energy_budget_j=60.0,
        budget_window_s=0.25))
    sched = ContinuousBatchingScheduler(eng, policy="idle_waiting", calibration=FixedCalibration(
        step_s=0.004, prefill_per_tok_s=0.001))
    rep = sched.run(poisson_stream(4, rate_hz=40.0, seed=1, vocab_size=tcfg.vocab_size,
                                   prompt_lens=(4,), new_tokens=(3, 6)))
    assert sched.faults is prof and rep.quarantined > 0 and rep.items == 4
    assert 0.0 < rep.peak_budget_window_j <= 60.0 * (1 + 1e-9)
    sched.pool.check_invariants()


def test_a_small_pool_admits_more_than_contiguous_bytes_would_hold():
    """Pages below the contiguous worst case: requests that map few pages
    share a pool whose bytes would hold fewer contiguous slots, and its
    allocation is ``paged_cache_bytes``."""
    _, _, tcfg, tp = weights("granite-3-8b")
    eng = InferenceEngine(tcfg, params=tp, sc=ServeConfig(
        max_batch=4, max_len=MAX_LEN, paged=True, page_size=PAGE, num_pages=13), device="cpu")
    pool = eng.make_pool()
    from repro_torch.serving.kv_cache import cache_bytes
    paged_b = sum(v.nbytes for v in pool.cache.values()) + pool.table.nbytes
    assert paged_b == paged_cache_bytes(tcfg, batch=4, num_pages=13, page_size=PAGE,
                                        max_blocks=pool.max_blocks)
    per_slot = cache_bytes(tcfg, batch=1, max_len=MAX_LEN)
    assert paged_b // per_slot < 4
    chains = {}
    for s in range(4):
        assert pool.can_admit(5, 4)
        chains[s] = [eng.prefill_into_slot(pool, s, prompt(20 + s, 5), rid=s, budget=4)]
    decode_ticks(eng, pool, chains, 3)
    assert all(len(c) == 4 for c in chains.values()) and pool.active_count == 0
    pool.check_invariants()


def test_the_tick_counts_the_same_launches_as_the_contiguous_tick(monkeypatch):
    """On the CPU no kernel launches, so the int8 products a tick calls are
    counted at ``qeinsum``'s call of ``int8_matmul``: the paged tick makes
    the contiguous tick's calls at the same row counts."""
    from repro_torch.models import quant as tquant

    _, _, tcfg, tp = weights("granite-3-8b")
    qcfg = dataclasses.replace(tcfg, quant="int8")
    rows = {}
    real = tquant.int8_matmul
    for name, sc in (("contiguous", {}), ("paged", PAGED)):
        eng = InferenceEngine(qcfg, params=tp, sc=ServeConfig(max_batch=MAX_BATCH,
                                                               max_len=MAX_LEN, **sc),
                              device="cpu")
        pool = eng.make_pool()
        eng.prefill_into_slot(pool, 0, prompt(1, 5), rid=0, budget=4)
        seen = rows[name] = []
        monkeypatch.setattr(tquant, "int8_matmul",
                            lambda *a, **kw: seen.append(int(a[0].shape[0])) or real(*a, **kw))
        eng.masked_decode_step(pool)
        monkeypatch.setattr(tquant, "int8_matmul", real)
    assert rows["paged"] == rows["contiguous"] and len(rows["paged"]) == 7 * tcfg.num_layers
    assert runtime.launch_counts().get("int8_matmul", 0) == 0
