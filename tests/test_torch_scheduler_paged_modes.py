"""The port's scheduler over paged pools against the reference's, on the
CPU, under chunked admission and speculative verify
(``tests/test_paged_serving.py::test_paged_chunked_and_speculative_identical``):
a chunked group activates from its contiguous group cache into pages, and
verify windows write tail blocks allocated on demand, with no
``spec_slack`` rows; the tokens are the contiguous pool's.

Helpers and criterion are ``test_torch_scheduler_paged``'s (``assert_same``
of ``test_torch_scheduler``: tokens, flags and integer counters identical
to the reference's, floats within 1e-9 relative; every paged pool drained
with its refcounts conserved)."""
import pytest

from test_torch_preemption import drained
from test_torch_scheduler import run_both, tokens
from test_torch_scheduler_paged import bursty, pairs


@pytest.mark.parametrize("arch", ("granite-3-8b", "zamba2-7b"))
def test_paged_chunked_and_speculative_identical(arch):
    contig, paged = pairs(arch, max_batch=3, max_len=48, slack=4)
    reqs = bursty(contig, n=8)
    _, chunked, _, _ = run_both(contig, reqs, policy="adaptive", prefill_chunk=3)
    _, rep, _, sched = run_both(paged, reqs, policy="adaptive", prefill_chunk=3)
    assert rep.chunks > 0 and tokens(chunked) == tokens(rep)
    drained(sched)
    _, spec, _, _ = run_both(contig, reqs, policy="adaptive", speculate_k=3)
    _, rep, _, sched = run_both(paged, reqs, policy="adaptive", speculate_k=3)
    assert rep.verify_ticks > 0 and tokens(spec) == tokens(rep)
    drained(sched)
