"""The port's roofline core (``repro_torch.core.cost_model``) against the
reference's: the same operations, bytes, peak, bandwidths and power through
both packages' ``Roofline`` give the same step time, bottleneck and energy;
the dtype tables agree; and the H100 scores f32 against its CUDA-core rate.
Also the weight-bytes model shared by ``lstm_quant`` and the tuner."""
import dataclasses

import pytest

from repro.core import cost_model as jcm
from repro.core.energy import TPUChip
from repro_torch.core import cost_model as tcm
from repro_torch.core.energy import DEFAULT_CHIP, H100Chip


def _reference_chip(chip: H100Chip, dtype: str) -> TPUChip:
    """The reference's chip carrying the port chip's numbers for ``dtype``."""
    scored = tcm.chip_for_dtype(chip, dtype)
    return TPUChip(peak_flops=scored.peak_flops, peak_int8_ops=chip.peak_int8_ops,
                   hbm_bw=chip.hbm_bw, ici_bw=chip.link_bw, p_idle_w=chip.p_idle_w,
                   p_peak_w=chip.p_peak_w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("flops,nbytes,coll", [
    (1.2e12, 3.0e9, 0.0),     # compute-bound in every type but int8's
    (2.0e9, 5.2e7, 0.0),      # memory-bound: K5's weight at decode
    (1.0e9, 1.0e6, 4.0e9),    # collective-bound
    (0.0, 0.0, 0.0),
])
def test_roofline_matches_the_reference(dtype, flops, nbytes, coll):
    chip = tcm.chip_for_dtype(DEFAULT_CHIP, dtype)
    got = tcm.Roofline(flops, nbytes, coll, 2, flops * 0.8, chip)
    want = jcm.Roofline(flops, nbytes, coll, 2, flops * 0.8, _reference_chip(DEFAULT_CHIP, dtype))
    assert got.t_step_s == want.t_step_s
    assert got.t_step_noverlap_s == want.t_step_noverlap_s
    assert got.bottleneck == want.bottleneck
    assert got.energy_j() == want.energy_j()
    assert got.summary() == want.summary()


@pytest.mark.parametrize("dtype", ["float64", "float32", "float16", "bfloat16", "int8", "int32",
                                   "lstm-int8", "torch.bfloat16", "complex"])
def test_dtype_bytes_match_the_reference(dtype):
    assert tcm.dtype_bytes(dtype) == jcm.dtype_bytes(dtype)
    assert tcm.DTYPE_BYTES == jcm.DTYPE_BYTES


def test_peaks_by_type():
    """f32 runs on the CUDA cores at 67 TFLOP/s, not at the bf16 tensor-core
    rate the reference's chip_for_dtype would give it (15x too fast)."""
    assert tcm.chip_for_dtype(DEFAULT_CHIP, "float32").peak_flops == 67e12
    assert tcm.chip_for_dtype(DEFAULT_CHIP, "bfloat16").peak_flops == 989e12
    assert tcm.chip_for_dtype(DEFAULT_CHIP, "float16").peak_flops == 989e12
    assert tcm.chip_for_dtype(DEFAULT_CHIP, "int8").peak_flops == 1979e12
    assert tcm.ridge_intensity(dtype="int8") == pytest.approx(
        2 * tcm.ridge_intensity(dtype="bfloat16"), rel=1e-3)
    assert tcm.ridge_intensity(dtype="float32") == pytest.approx(67e12 / 3.35e12)
    for flops, nbytes in ((1e9, 1e6), (5.0, 0.0)):
        assert tcm.arithmetic_intensity(flops, nbytes) == jcm.arithmetic_intensity(flops, nbytes)


def test_chip_power_model_matches_the_reference_form():
    ref = TPUChip(p_idle_w=DEFAULT_CHIP.p_idle_w, p_peak_w=DEFAULT_CHIP.p_peak_w,
                  reload_bw=DEFAULT_CHIP.reload_bw, reload_fixed_s=DEFAULT_CHIP.reload_fixed_s)
    for u in (-0.5, 0.0, 0.3, 1.0, 2.0):
        assert DEFAULT_CHIP.step_power(u) == ref.step_power(u)
        for f in (0.25, 1.0):
            assert DEFAULT_CHIP.dvfs_power(u, f) == ref.dvfs_power(u, f)
    assert DEFAULT_CHIP.dvfs_power(0.7, 1.0) == DEFAULT_CHIP.step_power(0.7)
    assert DEFAULT_CHIP.reload_time(2.1e6) == ref.reload_time(2.1e6)
    assert dataclasses.replace(DEFAULT_CHIP, p_peak_w=500.0).step_power(1.0) == 500.0


def test_lstm_quant_footprint_matches_autotune_model():
    """lstm_quant.resident_weight_bytes IS the tuner's weight-bytes model
    (one source of truth), equals the reference's, and the int8/f32 delta of
    a resident block's shared memory is the payload's: the model's delta
    plus the two f32 scale vectors, which the kernel reads from memory."""
    from repro.kernels.lstm_quant import resident_weight_bytes as jref_bytes
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.lstm_quant import resident_weight_bytes

    for d, h in ((6, 20), (32, 32), (256, 256)):
        for dtype in ("float32", "int8"):
            model = at._lstm_weight_bytes({"d_in": d, "hidden": h}, dtype)
            assert resident_weight_bytes(d, h, dtype) == model == jref_bytes(d, h, dtype)
    assert resident_weight_bytes(256, 256) == 2_101_248
    assert resident_weight_bytes(256, 256, "int8") == 536_576

    prob = {"batch": 8, "seq": 16, "d_in": 32, "hidden": 32}
    cand = {"block_b": 2}
    delta_model = resident_weight_bytes(32, 32, "float32") - resident_weight_bytes(32, 32, "int8")
    delta_smem = (at.vmem_footprint_bytes("lstm_seq", prob, cand, dtype="float32")
                  - at.vmem_footprint_bytes("lstm_seq", prob, cand, dtype="int8"))
    assert delta_smem == delta_model + 2 * 4 * 32 * 4
