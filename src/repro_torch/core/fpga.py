"""The paper's LSTM workload at its published shape.

Only the workload description is ported so far; the FPGA resource, latency
and energy model of the reference's ``core/fpga.py`` is not.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LSTMWorkload:
    seq: int = 28
    d_in: int = 6
    hidden: int = 20

    @property
    def macs_per_step(self) -> int:
        return 4 * self.hidden * (self.d_in + self.hidden + 1)

    @property
    def act_per_step(self) -> int:
        return 5 * self.hidden

    @property
    def ew_per_step(self) -> int:
        return 3 * self.hidden

    @property
    def total_ops(self) -> int:
        # 2 ops/MAC + activations + elementwise mult-adds (2 ops each)
        return self.seq * (2 * self.macs_per_step + self.act_per_step + 2 * self.ew_per_step)


def paper_workload() -> LSTMWorkload:
    return LSTMWorkload()
