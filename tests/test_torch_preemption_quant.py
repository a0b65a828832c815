"""The port's scheduler preempting int8 pages against the reference's, on
the CPU: ``tests/test_quantized_serving.py``'s
``test_quantized_preemption_token_identical_to_undisturbed``.  Both engines
quantize the same f32 weights to the same bytes at init
(``test_torch_quant_serving``) and keep K/V pages in int8 with an f32 scale
a row.

Helpers and criterion are ``test_torch_preemption``'s (``assert_same`` of
``test_torch_scheduler``: tokens, flags and integer counters identical to
the reference's, floats within 1e-9 relative; every pool drained with its
refcounts conserved)."""
import pytest

from test_torch_preemption import pair_of, press, run, stream
from test_torch_scheduler import tokens


@pytest.mark.parametrize("arch", ("granite-3-8b", "zamba2-7b"))
def test_quantized_preemption_token_identical_to_undisturbed(arch):
    """int8 weights and int8 KV pages: the same engine gives the same tokens
    whether or not it was preempted and restored (swap moves the payload
    and scale pages as they are), and the reference's."""
    ref, tight = pair_of(arch, quant="int8", kv_quant="int8")
    reqs = stream(ref)
    base = run(ref, reqs)
    rep = run(tight, reqs, preempt="tiered", swap=True, make=lambda P: {"faults": press(P)})
    assert rep.preempted > 0 and rep.swapped > 0
    assert tokens(rep) == tokens(base)
