"""Power and energy models of the two hardware backends.

``FPGABoard`` is the reference's, carried verbatim: its constants are
calibrated so that the paper's published numbers (C1–C4) reproduce from the
analytical models, and every calibrated value is marked ``# CAL``.

``H100Chip`` takes the place of the reference's TPU chip: the card the
port's kernels run on, with the figures the block-size tuner
(``kernels/autotune.py``) and the roofline (``core/cost_model.py``) read.
Each value names its source: NVIDIA's H100 SXM data sheet and Hopper
tuning guide, or the ``chip_smoke.py`` run that measured it on an
NVIDIA H100 80GB HBM3 at a 700 W power limit.  ``chip_smoke.py`` holds the
data-sheet values against ``torch.cuda.get_device_properties`` and the
cluster slots against ``kernels.lstm_seq.cluster_slots`` on every run.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FPGABoard:
    """Spartan-7-class board (Elastic Node V targets XC7S15/XC7S25)."""

    name: str = "spartan7-xc7s15"
    clock_hz: float = 100e6  # paper §5.1: 100 MHz on XC7S15
    # Resource budget (XC7S15: 8000 LUT6, 20 DSP48E1, 10 BRAM36)
    dsp: int = 20
    lut: int = 8000
    bram_kb: int = 360
    # Power model.
    p_idle_w: float = 0.028  # CAL: Spartan-7 quiescent+idle ≈ 28 mW
    p_cfg_w: float = 0.1414  # CAL: with t_cfg, gives E_cfg ≈ 14.14 mJ → C3 = 12.39×
    t_cfg_s: float = 0.100   # CAL: SPI bitstream load ~100 ms (XC7S15, ref [6] regime)
    p_lut_w: float = 4.17559e-5  # CAL: effective dynamic W per active LUT   } solved 2×2 from
    p_dsp_w: float = 1.195278e-2 # CAL: effective dynamic W per active DSP  } published EE pair
    #   (5.57, 12.98 GOPS/s/W at the two templates' resource mixes — core/fpga.py docstring)

    @property
    def e_cfg_j(self) -> float:
        return self.p_cfg_w * self.t_cfg_s

    def active_power(self, lut_used: int, dsp_used: int) -> float:
        return self.p_idle_w + lut_used * self.p_lut_w + dsp_used * self.p_dsp_w


@dataclasses.dataclass(frozen=True)
class H100Chip:
    """NVIDIA H100 SXM (80 GB HBM3), the card the port's kernels are built for."""

    name: str = "h100-sxm"
    # Dense peak rates per operand type (data sheet, no sparsity): f32 on the
    # CUDA cores outside the tensor cores, bf16/fp16 and int8 on the tensor cores.
    peak_f32_flops: float = 67e12
    peak_flops: float = 989e12       # bf16 / fp16 tensor cores
    peak_int8_ops: float = 1979e12
    hbm_bw: float = 3.35e12          # bytes/s (data sheet)
    hbm_bytes: int = 80 * 10**9      # 80 GB (data sheet)
    smem_per_block: int = 232448     # 227 KB a block may opt in to (Hopper tuning guide)
    smem_per_sm: int = 233472        # 228 KB of shared memory an SM (Hopper tuning guide)
    sms: int = 132                   # streaming multiprocessors of the SXM part (data sheet)
    threads_per_sm: int = 2048       # resident threads an SM (CUDA programming guide, cc 9.0)
    blocks_per_sm: int = 32          # resident blocks an SM (same table)
    registers_per_sm: int = 65536    # 32-bit registers an SM (Hopper tuning guide)
    l2_bytes: int = 50 * 1024**2     # 50 MB of L2 (data sheet)
    cluster_size: int = 8            # blocks a cluster may hold without opting in (portable size)
    cluster_slots: int = 15          # clusters of 8 at one block an SM held at once: the card's
    #   cudaOccupancyMaxActiveClusters for the LSTM cluster kernel (chip_smoke.py's kernels
    #   line, every run on record in PERF.md)
    link_bw: float = 450e9           # NVLink 4, bytes/s each way (data sheet: 900 GB/s both ways)
    # Power: the limit of the cards the runs used, and the rest measured by
    # chip_smoke.py's energy line in run A of the tuner's calibration (PERF.md
    # §6; NVIDIA H100 80GB HBM3, 700.00 W).
    p_idle_w: float = 126.4          # `power.draw` of the card idle 3 s, its context held (run A)
    p_peak_w: float = 700.0          # `power.limit` (nvidia-smi)
    # "Configuration" analogue: loading the built kernel library and the
    # first launch, then refilling weights over PCIe from pinned host memory.
    reload_bw: float = 46.6e9        # bytes/s, pinned copy of one granite-3-8b layer (run A)
    reload_fixed_s: float = 0.0132   # s, ctypes load of the kernel library + first launch (run A)

    def step_power(self, compute_util: float) -> float:
        """Linear idle→peak power model in compute utilization."""
        u = min(max(compute_util, 0.0), 1.0)
        return self.p_idle_w + (self.p_peak_w - self.p_idle_w) * u

    def dvfs_power(self, compute_util: float, clock_frac: float) -> float:
        """Power at a throttled clock: the dynamic term scales with the clock
        fraction, the static/idle term does not; ``dvfs_power(u, 1.0) ==
        step_power(u)``."""
        u = min(max(compute_util, 0.0), 1.0)
        f = min(max(clock_frac, 0.0), 1.0)
        return self.p_idle_w + (self.p_peak_w - self.p_idle_w) * u * f

    def reload_time(self, weight_bytes: float) -> float:
        return self.reload_fixed_s + weight_bytes / self.reload_bw


DEFAULT_BOARD = FPGABoard()
DEFAULT_CHIP = H100Chip()
