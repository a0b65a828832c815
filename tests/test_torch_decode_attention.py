"""K7 ``decode_attention`` on the CPU: its plain version, the split plan the
kernel launches with, the kernel's split-and-merge arithmetic, the
wrapper's checks and what ``models/layers.attention_decode`` counts.

The kernel itself runs only on the card (``chip_smoke.py``'s
``check_decode_attention``); here its plain version stands in for it, and
``_split_and_merge`` repeats its dataflow in f32 tensor ops."""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config, list_archs
from repro_torch.core import tracing
from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import (
    GROUP_MAX, HEAD_DIMS, ROW_MAX, decode_attention, decode_attention_plain, plain_scores, plan,
)
from repro_torch.models import layers

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

# (B, KV, D, g) of the three served cells: granite-3-8b chat, granite-moe
# batch, granite-3-8b long documents
CELLS = [(32, 8, 128, 4), (32, 8, 64, 3), (8, 8, 128, 4)]


def _operands(seed, b, s, kv, d, g, dtype=torch.float32, garbage=1e6):
    """q, caches and positions (0 and s - 1 among them); every cache row past
    a row's position holds large finite garbage."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, 1, kv * g, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(np.float32))
            for _ in range(2))
    pos = torch.from_numpy(rng.integers(0, s, b))
    pos[0], pos[-1] = 0, s - 1
    dead = torch.arange(s)[None, :] > pos[:, None]
    for c in (k, v):
        c[dead] = garbage * torch.from_numpy(rng.uniform(-1, 1, (int(dead.sum()), kv, d))
                                             .astype(np.float32))
    return q.to(dtype), k.to(dtype), v.to(dtype), pos


def split_ranges(p, smax):
    """The cache rows each split of plan ``p`` reads (the kernel's block
    ``split`` starts at ``split * rows``), up to every row of the capacity."""
    return [range(i * p.rows, min((i + 1) * p.rows, smax)) for i in range(p.splits)]


def _sliced(q, k, v, pos):
    """Row b's attention over its live rows alone, ``[:pos[b] + 1]``."""
    out = []
    for b in range(q.shape[0]):
        n = int(pos[b]) + 1
        g = q.shape[2] // k.shape[2]
        kb = k[b, :n].float().repeat_interleave(g, dim=1)
        vb = v[b, :n].float().repeat_interleave(g, dim=1)
        s = torch.einsum("hd,khd->hk", q[b, 0].float(), kb) / float(np.sqrt(np.float32(q.shape[3])))
        out.append(torch.einsum("hk,khd->hd", torch.softmax(s, dim=-1), vb))
    return torch.stack(out)[:, None]


def _split_and_merge(q, k, v, pos):
    """The kernel's dataflow in f32: each split of the plan holding a row <=
    pos[b] takes its own softmax (max, exp, sum) and P·V over its live rows;
    the splits merge with weights exp(max_s - max)."""
    b_, _, h, d = q.shape
    s_, kv = k.shape[1], k.shape[2]
    g = h // kv
    p = plan(b_, s_, kv, g)
    out = torch.empty((b_, 1, h, d))
    for b in range(b_):
        last = min(max(int(pos[b]), 0), s_ - 1)
        parts = []
        for rows in split_ranges(p, s_):
            if rows.start > last:
                break
            live = slice(rows.start, min(rows.stop, last + 1))
            kb = k[b, live].float().repeat_interleave(g, dim=1)
            vb = v[b, live].float().repeat_interleave(g, dim=1)
            sc = torch.einsum("hd,khd->hk", q[b, 0].float(), kb) / float(np.sqrt(np.float32(d)))
            m = sc.amax(dim=-1)
            e = torch.exp(sc - m[:, None])
            parts.append((m, e.sum(dim=-1), torch.einsum("hk,khd->hd", e, vb)))
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        w = [torch.exp(m - mx) for m, _, _ in parts]
        l_ = sum(l * wi for (_, l, _), wi in zip(parts, w))
        o = sum(o * wi[:, None] for (_, _, o), wi in zip(parts, w))
        out[b, 0] = o / l_[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("b,kv,d,g", [(4, 8, 128, 4), (4, 8, 64, 3), (2, 2, 16, 2), (3, 2, 112, 1)])
@pytest.mark.parametrize("s", [1, 17, 96])
def test_plain_over_the_capacity_equals_attention_over_the_live_rows(b, kv, d, g, s):
    """Rows past pos weigh exactly 0 in the plain version, whatever they
    hold: it equals the attention over each row's slice, the equivalence the
    kernel's reading of the live rows alone rests on."""
    q, k, v, pos = _operands(b * 100 + s, b, s, kv, d, g)
    got = decode_attention_plain(q, k, v, pos)
    assert got.shape == (b, 1, kv * g, d) and got.dtype == torch.float32
    torch.testing.assert_close(got, _sliced(q, k, v, pos), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_casts_once_to_q_type(dtype):
    q, k, v, pos = _operands(3, 3, 40, 2, 16, 2, dtype=dtype, garbage=1.0)
    got = decode_attention_plain(q, k, v, pos)
    assert got.dtype == dtype
    torch.testing.assert_close(got, _sliced(q, k, v, pos).to(dtype), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("b,kv,d,g", CELLS)
@pytest.mark.parametrize("s", [1, 17, 1536, 16384, 32768])
def test_split_plan_reads_every_row_once(b, kv, d, g, s):
    p = plan(b, s, kv, g)
    ranges = split_ranges(p, s)
    rows = [r for rng in ranges for r in rng]
    assert rows == list(range(s))            # none lost, none read twice, in order
    assert all(len(rng) >= 1 for rng in ranges) and len(ranges) == p.splits
    assert 1 <= p.rows <= ROW_MAX and g % p.heads == 0 and p.heads <= GROUP_MAX
    assert p.heads == g                      # each KV row read once for all its query heads
    if s >= 1536:  # a full pool fills the card: several blocks an SM
        assert b * kv * (g // p.heads) * p.splits >= 4 * runtime.SM_COUNT


@pytest.mark.parametrize("b,kv,d,g,s", [(4, 8, 128, 4, 1536), (3, 8, 64, 3, 700),
                                        (2, 2, 16, 12, 1100), (2, 4, 112, 1, 2049)])
def test_split_and_merge_equals_the_plain_version(b, kv, d, g, s):
    """The kernel's arithmetic (splits, their softmax, the merge) against
    the plain version, within f32 rounding; NaN past pos leaves it finite."""
    q, k, v, pos = _operands(7 * s + g, b, s, kv, d, g)
    want = decode_attention_plain(q, k, v, pos)
    torch.testing.assert_close(_split_and_merge(q, k, v, pos), want, rtol=2e-5, atol=2e-6)
    dead = torch.arange(s)[None, :] > pos[:, None]
    k[dead], v[dead] = float("nan"), float("nan")
    got = _split_and_merge(q, k, v, pos)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    # the plain version's 0 * NaN is NaN: row 0, at position 0, has dead rows
    assert not bool(torch.isfinite(decode_attention_plain(q, k, v, pos)[0]).all())


def test_every_gqa_config_has_a_built_head_width():
    """No GQA decode the port serves on the card meets a head width or
    group the kernel is not built for."""
    for arch in list_archs():
        for cfg in (get_config(arch), get_reduced_config(arch)):
            if cfg.num_heads == 0 or cfg.mla is not None:
                continue
            assert cfg.resolved_head_dim in HEAD_DIMS, (arch, cfg.resolved_head_dim)
            p = plan(4, 1024, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads)
            assert (cfg.num_heads // cfg.num_kv_heads) % p.heads == 0


def test_constants_are_the_kernels():
    src = (CSRC / "decode_attention.cu").read_text()
    assert int(re.search(r"constexpr int kRowMax = (\d+);", src).group(1)) == ROW_MAX
    assert tuple(int(x) for x in re.findall(r"if \(D == (\d+)\) return launch_d", src)) \
        == HEAD_DIMS
    assert int(re.search(r"hg > (\d+)", src).group(1)) == GROUP_MAX


def test_kernel_doc_covers_k7():
    text = (CSRC.parents[2] / "docs" / "torch_kernels.md").read_text()
    assert "## K7 · `decode_attention`" in text and "| K7 |" in text
    assert "`csrc/decode_attention.cu`" in text


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v, pos = _operands(1, 3, 20, 2, 16, 2)
    runtime.reset_launch_counts()
    got = decode_attention(q, k, v, pos)
    assert runtime.launch_counts() == {}
    assert torch.equal(got, decode_attention_plain(q, k, v, pos))


def test_attention_decode_on_cpu_counts_its_calls_and_launches_nothing():
    q, k, v, pos = _operands(2, 3, 20, 2, 16, 2)
    runtime.reset_launch_counts()
    calls, scored = tracing.counter("attn.decode_calls"), tracing.counter("attn.rows_scored")
    got = layers.attention_decode(q, k, v, pos)
    assert tracing.counter("attn.decode_calls") == calls + 1
    assert tracing.counter("attn.rows_scored") == scored + 3 * 20
    assert runtime.launch_counts() == {}
    assert torch.equal(got, decode_attention_plain(q, k, v, pos))


@pytest.mark.parametrize("b,kv,d,g", [(3, 2, 16, 2), (2, 4, 64, 1)])
def test_plain_scores_without_a_mask_score_every_row(b, kv, d, g):
    """The mesh's split path scores a slice with no mask (whisper's
    cross-attention) through ``plain_scores``: the scores of a mask that
    keeps every row, and with their softmax the plain version at the last
    position."""
    q, k, v, _ = _operands(5, b, 24, kv, d, g)
    last = torch.full((b,), 23)
    s, vx = plain_scores(q, k, v, None)
    kept, _ = plain_scores(q, k, v, torch.ones(b, 24, dtype=torch.bool))
    assert torch.equal(s, kept) and vx.shape == (b, 24, kv * g, d)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vx)
    assert torch.equal(out, decode_attention_plain(q, k, v, last))


def test_attention_decode_takes_no_position_only_on_a_split():
    q, k, v, _ = _operands(6, 2, 12, 2, 16, 2)
    with pytest.raises(ValueError, match="one position a row"):
        layers.attention_decode(q, k, v, None)


# ---------------------------------------------------------------------------
# The wrapper's checks.  Shapes are checked on both devices; what the kernel
# is built for on its branch, reached here by CPU tensors that report the
# card, with the launch replaced by one that fails the test.
# ---------------------------------------------------------------------------
CARD = torch.device("cuda", 0)


class OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0."""

    @property
    def device(self):
        return CARD

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _card(*tensors):
    return [t.as_subclass(OnCard) for t in tensors]


def _refuse(*args, **kwargs):
    raise AssertionError("the wrapper reached the launch")


def _args(d=16, dtype=torch.bfloat16, **over):
    t = {"q": torch.zeros(2, 1, 4, d, dtype=dtype), "k": torch.zeros(2, 8, 2, d, dtype=dtype),
         "v": torch.zeros(2, 8, 2, d, dtype=dtype), "pos": torch.zeros(2, dtype=torch.int64)}
    t.update(over)
    return [t[n] for n in ("q", "k", "v", "pos")]


def _misaligned(*shape, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=dtype)
    skip = next(i for i in range(1, 8) if (base.data_ptr() + i * base.element_size()) % 16)
    return base[skip:skip + n].view(shape)


@pytest.mark.parametrize("bad,error,match", [
    ("head_width", ValueError, "head widths"),
    ("cache_dtype", TypeError, "caches"),
    ("mixed_caches", TypeError, "caches"),
    ("q_dtype", TypeError, "q"),
    ("pos_dtype", TypeError, "positions"),
    ("non_contiguous_cache", ValueError, "contiguous"),
    ("misaligned_cache", ValueError, "16-byte"),
    ("pos_shape", ValueError, "one position a row"),
    ("kv_heads", ValueError, "do not divide"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, bad, error, match):
    monkeypatch.setattr(runtime, "launch", _refuse)
    args = {
        "head_width": _args(d=32),
        "cache_dtype": _args(k=torch.zeros(2, 8, 2, 16, dtype=torch.float16),
                             v=torch.zeros(2, 8, 2, 16, dtype=torch.float16)),
        "mixed_caches": _args(v=torch.zeros(2, 8, 2, 16)),
        "q_dtype": _args(q=torch.zeros(2, 1, 4, 16, dtype=torch.float64)),
        "pos_dtype": _args(pos=torch.zeros(2)),
        "non_contiguous_cache": _args(k=torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16)
                                      .transpose(1, 2)),
        "misaligned_cache": _args(v=_misaligned(2, 8, 2, 16)),
        "pos_shape": _args(pos=torch.zeros(2, 1, dtype=torch.int64)),
        "kv_heads": _args(q=torch.zeros(2, 1, 3, 16, dtype=torch.bfloat16)),
    }[bad]
    with pytest.raises(error, match=match):
        decode_attention(*_card(*args))
    if bad in ("pos_shape", "kv_heads"):  # shapes are refused on the CPU too
        with pytest.raises(error, match=match):
            decode_attention(*args)


def test_wrapper_refuses_mixed_devices(monkeypatch):
    monkeypatch.setattr(runtime, "launch", _refuse)
    q, k, v, pos = _args()
    with pytest.raises(ValueError, match="different devices"):
        decode_attention(*_card(q, k, v), pos)

