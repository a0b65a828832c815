"""The kernel wrappers' checks, on the CPU.

A wrapper given CUDA tensors checks device, type, shape, contiguity and
alignment before it allocates or launches anything.  Those checks run on
the kernel branch, which CPU tensors never take, so here the tensors are
CPU tensors that report the card (``OnCard``): a wrapper then takes its
kernel branch and must raise before it reaches the launch, which the test
replaces by one that fails the test.
"""
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.activations import activation
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.lstm_cell import lstm_cell_fused
from repro_torch.kernels.lstm_quant import quantize_lstm_weights
from repro_torch.kernels.lstm_seq import lstm_seq_fused, lstm_seq_fused_quantized, lstm_stack_fused

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


def card(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(OnCard)


@pytest.fixture(autouse=True)
def no_launch(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper reached the launch")

    monkeypatch.setattr(runtime, "launch", refuse)


def misaligned(*shape, dtype=torch.float32):
    """Contiguous, but starting 4 bytes past a 16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    base = torch.zeros(n + 4, dtype=dtype)
    skip = next(i for i in range(1, 16) if (base.data_ptr() + i * base.element_size()) % 16)
    return base[skip:skip + n].view(shape)


def test_on_card_tensors_take_the_kernel_branch():
    x = card(torch.zeros(4, 8))
    assert x.is_cuda and x.device == CARD and runtime.require_same_device(x, x) == CARD
    with pytest.raises(AssertionError, match="launch"):
        activation(card(torch.zeros(4, 8)))


def _cell(**over):
    t = {"x": torch.zeros(4, 6), "h": torch.zeros(4, 20), "c": torch.zeros(4, 20),
         "w": torch.zeros(6, 80), "u": torch.zeros(20, 80), "b": torch.zeros(80)}
    t.update(over)
    return t


def _seq(**over):
    t = {"x": torch.zeros(4, 7, 6), "w": torch.zeros(6, 80), "u": torch.zeros(20, 80),
         "b": torch.zeros(80)}
    t.update(over)
    return t


def _stack(**over):
    t = {"x": torch.zeros(4, 7, 6), "l0": (torch.zeros(6, 80), torch.zeros(20, 80),
                                            torch.zeros(80)),
         "l1": (torch.zeros(20, 80), torch.zeros(20, 80), torch.zeros(80))}
    t.update(over)
    return t


def call(kernel, tensors, on_card=True):
    wrap = card if on_card else (lambda t: t)
    if kernel == "lstm_cell":
        return lstm_cell_fused(*(wrap(tensors[k]) for k in "xhcwub"))
    if kernel == "lstm_seq":
        return lstm_seq_fused(*(wrap(tensors[k]) for k in ("x", "w", "u", "b")))
    if kernel == "lstm_seq_q8":
        qw = quantize_lstm_weights(tensors["w"], tensors["u"], tensors["b"], 20)
        if "u_q" in tensors:  # replaces the quantized u
            qw = qw._replace(u_q=tensors["u_q"](qw.u_q))
        qw = type(qw)(*(wrap(t) if isinstance(t, torch.Tensor) else t for t in qw))
        return lstm_seq_fused_quantized(wrap(tensors["x"]), qw)
    if kernel == "lstm_stack":
        layers = [tuple(wrap(t) for t in tensors[k]) for k in ("l0", "l1")]
        return lstm_stack_fused(wrap(tensors["x"]), layers)
    raise KeyError(kernel)


@pytest.mark.parametrize("kernel,tensors", [
    ("lstm_cell", _cell(w=torch.zeros(80, 6).t())),
    ("lstm_cell", _cell(h=torch.zeros(20, 4).t())),
    ("lstm_seq", _seq(u=torch.zeros(80, 20).t())),
    ("lstm_seq_q8", _seq(u_q=lambda u: u.t().contiguous().t())),
    # the stack stacks layers 1.. into new tensors; layer 0's w is its own
    ("lstm_stack", _stack(l0=(torch.zeros(80, 6).t(), torch.zeros(20, 80), torch.zeros(80)))),
])
def test_lstm_wrappers_refuse_non_contiguous(kernel, tensors):
    with pytest.raises(ValueError, match="contiguous"):
        call(kernel, tensors)


@pytest.mark.parametrize("kernel,tensors", [
    ("lstm_cell", _cell(u=misaligned(20, 80))),
    ("lstm_cell", _cell(x=misaligned(4, 6))),
    ("lstm_seq", _seq(w=misaligned(6, 80))),
    ("lstm_seq", _seq(b=misaligned(80))),
    ("lstm_seq_q8", _seq(u_q=lambda u: misaligned(*u.shape, dtype=torch.int8))),
    ("lstm_stack", _stack(l0=(misaligned(6, 80), torch.zeros(20, 80), torch.zeros(80)))),
])
def test_lstm_wrappers_refuse_misaligned(kernel, tensors):
    with pytest.raises(ValueError, match="16-byte"):
        call(kernel, tensors)


@pytest.mark.parametrize("kernel,tensors", [
    ("lstm_cell", _cell(c=torch.zeros(4, 20, dtype=torch.float64))),
    ("lstm_seq", _seq(x=torch.zeros(4, 7, 6, dtype=torch.bfloat16))),
    ("lstm_seq", _seq(u=torch.zeros(20, 80, dtype=torch.float16))),
    ("lstm_stack", _stack(x=torch.zeros(4, 7, 6, dtype=torch.float64))),
])
@pytest.mark.parametrize("on_card", [True, False])
def test_lstm_wrappers_refuse_other_types(kernel, tensors, on_card):
    with pytest.raises(TypeError):
        call(kernel, tensors, on_card)


@pytest.mark.parametrize("kernel", ["lstm_cell", "lstm_seq", "lstm_seq_q8", "lstm_stack"])
def test_lstm_wrappers_refuse_mixed_devices(kernel):
    tensors = {"lstm_cell": _cell, "lstm_seq": _seq, "lstm_seq_q8": _seq,
               "lstm_stack": _stack}[kernel]()
    # the input on the card, the weights on the CPU
    wrap_x = dict(tensors, x=card(tensors["x"]))
    with pytest.raises(ValueError, match="different devices"):
        call(kernel, wrap_x, on_card=False)


def test_activation_checks():
    with pytest.raises(TypeError):
        activation(card(torch.zeros(4, 8, dtype=torch.float64)))
    with pytest.raises(ValueError, match="contiguous"):
        activation(card(torch.zeros(8, 4).t()))
    with pytest.raises(ValueError, match="device"):
        activation(torch.zeros(4, 8, device="meta"))
    with pytest.raises(ValueError):
        activation(card(torch.zeros(4, 8)), fn="softmax")
    with pytest.raises(ValueError):
        activation(card(torch.zeros(4, 8)), impl="cubic")


def _int8(**over):
    t = {"x": torch.zeros(4, 64, dtype=torch.int8), "w": torch.zeros(64, 32, dtype=torch.int8),
         "sx": torch.ones(4, 1), "sw": torch.ones(32)}
    t.update(over)
    return [t[k] for k in ("x", "w", "sx", "sw")]


def test_int8_matmul_checks():
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(*map(card, _int8(w=torch.zeros(32, 64, dtype=torch.int8).t())))
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(*map(card, _int8(sw=torch.ones(64)[::2])))
    with pytest.raises(TypeError):
        int8_matmul(*map(card, _int8(x=torch.zeros(4, 64))))
    x, w, sx, sw = _int8()
    with pytest.raises(ValueError, match="different devices"):
        int8_matmul(card(x), w, sx, sw)


def _flash(**over):
    t = {"q": torch.zeros(1, 4, 8, 16), "k": torch.zeros(1, 2, 8, 16),
         "v": torch.zeros(1, 2, 8, 16)}
    t.update(over)
    return [t[k] for k in "qkv"]


def test_flash_attention_checks():
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(*map(card, _flash(k=torch.zeros(1, 2, 16, 8).transpose(2, 3))))
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(*map(card, _flash(v=misaligned(1, 2, 8, 16))))
    with pytest.raises(TypeError):
        flash_attention(*map(card, _flash(q=torch.zeros(1, 4, 8, 16, dtype=torch.float64))))
    with pytest.raises(ValueError, match="head widths"):
        flash_attention(*map(card, [torch.zeros(1, 4, 8, 24), torch.zeros(1, 2, 8, 24),
                                    torch.zeros(1, 2, 8, 24)]))
    q, k, v = _flash()
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(card(q), k, v)
