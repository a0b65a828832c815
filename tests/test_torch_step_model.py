"""The port's step cost model (``repro_torch.core.cost_model``: the FLOP and
HBM-byte models, ``MeshPlan``, ``estimate_step``, ``GPUCostBackend``) and the
train launcher's plan mode against the reference's, on a chip carrying the
reference TPU's constants (``TPU_CHIP``): all ten archs, the four shapes and
the mesh plans (1, 1), (16, 16), (32, 16, fsdp), (128, 1), at 1e-12
relative (the arithmetic is the same, operation for operation); the
Generator's best, ranking and pruned list over ``GPUCostBackend`` equal to
those over ``TPUCostBackend``; the plan's stdout equal to the reference's."""
import contextlib
import dataclasses
import io

import pytest

from repro.configs import get_config as jax_config
from repro.core import constraints as jcons
from repro.core import cost_model as jcm
from repro.core import generator as jgen
from repro.core.energy import DEFAULT_CHIP as TPU
from repro.launch import train as jlaunch
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.core import constraints as tcons
from repro_torch.core import cost_model as tcm
from repro_torch.core import generator as tgen
from repro_torch.core.candidates import DesignPoint, DesignSpace
from repro_torch.core.energy import DEFAULT_CHIP
from repro_torch.launch import train as tlaunch

REL = 1e-12
# H100Chip carrying the reference TPU's numbers (its ici_bw as link_bw)
TPU_CHIP = dataclasses.replace(
    DEFAULT_CHIP, peak_flops=TPU.peak_flops, peak_int8_ops=TPU.peak_int8_ops,
    hbm_bw=TPU.hbm_bw, hbm_bytes=TPU.hbm_bytes, link_bw=TPU.ici_bw, p_idle_w=TPU.p_idle_w,
    p_peak_w=TPU.p_peak_w, reload_bw=TPU.reload_bw, reload_fixed_s=TPU.reload_fixed_s)
ARCHS = list_archs()
PLANS = [(1, 1, False), (16, 16, False), (32, 16, True), (128, 1, False)]
POINTS = [DesignPoint.of(), DesignPoint.of(remat="none"), DesignPoint.of(remat="dots"),
          DesignPoint.of(attention_impl="flash"),
          DesignPoint.of(remat="none", attention_impl="chunked", activation_impl="pwl")]
ESTIMATE_FIELDS = ("latency_s", "power_active_w", "power_idle_w", "energy_per_inf_j",
                   "max_act_error", "cfg_energy_j", "cfg_time_s", "ops", "gops_per_w")


def close(got, want, what=""):
    """Numbers equal to REL, dicts key for key, strings and ints exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, float):
        assert got == want or abs(got - want) <= REL * max(abs(got), abs(want)), \
            (what, got, want)
    else:
        assert got == want, (what, got, want)


def test_chip_carries_the_reference_constants():
    assert TPU_CHIP.link_bw == TPU.ici_bw and TPU_CHIP.peak_flops == TPU.peak_flops
    assert tcm.DEFAULT_CHIP is DEFAULT_CHIP and DEFAULT_CHIP.peak_flops == 989e12


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_flop_models_match(arch):
    """``param_count`` / ``active_param_count`` and every FLOP model, at each
    shape's batch and length, equal the reference's."""
    t, j = get_config(arch), jax_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert tcm.matmul_params(t) == jcm.matmul_params(j)
    assert tcm.active_matmul_params(t) == jcm.active_matmul_params(j)
    for shape in SHAPES.values():
        b, s = shape["global_batch"], shape["seq_len"]
        for causal in (False, True):
            close(tcm.attention_flops(t, b, s, causal_discount=causal),
                  jcm.attention_flops(j, b, s, causal_discount=causal), "attention")
        close(tcm.train_model_flops(t, b, s), jcm.train_model_flops(j, b, s), "train")
        close(tcm.prefill_model_flops(t, b, s), jcm.prefill_model_flops(j, b, s), "prefill")
        close(tcm.decode_model_flops(t, b, s), jcm.decode_model_flops(j, b, s), "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_step_estimates_match(arch):
    """``hbm_bytes_terms`` term for term, ``bytes_per_device_estimate`` and
    every ``Roofline.summary`` field of ``estimate_step``, for the four
    shapes and four mesh plans (the default design point)."""
    t, j = get_config(arch), jax_config(arch)
    for shape_id in SHAPES:
        for dp, tp, fsdp in PLANS:
            tp_plan, jp_plan = tcm.MeshPlan(dp, tp, fsdp), jcm.MeshPlan(dp, tp, fsdp)
            assert tp_plan.chips == jp_plan.chips == dp * tp
            what = f"{arch} {shape_id} {dp}x{tp}"
            close(tcm.hbm_bytes_terms(t, shape_id, tp_plan),
                  jcm.hbm_bytes_terms(j, shape_id, jp_plan), what)
            close(tcm.bytes_per_device_estimate(t, shape_id, tp_plan),
                  jcm.bytes_per_device_estimate(j, shape_id, jp_plan), what)
            got = tcm.estimate_step(t, shape_id, tp_plan, chip=TPU_CHIP)
            want = jcm.estimate_step(j, shape_id, jp_plan)
            close(got.summary(), want.summary(), what)
            close(got.coll_bytes_per_dev, want.coll_bytes_per_dev, what)


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b", "mamba2-780m",
                                  "zamba2-7b", "whisper-tiny"])
def test_design_points_move_the_estimate_as_the_reference(arch):
    """remat, attention impl and activation impl through ``estimate_step``
    and ``hbm_bytes_terms`` (the terms they select)."""
    t, j = get_config(arch), jax_config(arch)
    plan = (16, 16, False)
    for shape_id in ("train_4k", "prefill_32k", "decode_32k"):
        for point in POINTS:
            got = tcm.estimate_step(t, shape_id, tcm.MeshPlan(*plan), point, TPU_CHIP)
            want = jcm.estimate_step(j, shape_id, jcm.MeshPlan(*plan), point)
            close(got.summary(), want.summary(), f"{arch} {shape_id} {point}")
        for remat in ("none", "dots", "full"):
            for impl in ("naive", "flash"):
                close(tcm.hbm_bytes_terms(t, "train_4k", tcm.MeshPlan(*plan), remat=remat,
                                          attention_impl=impl),
                      jcm.hbm_bytes_terms(j, "train_4k", jcm.MeshPlan(*plan), remat=remat,
                                          attention_impl=impl), f"{remat} {impl}")


BACKEND_CASES = [("granite-3-8b", "decode_32k", (16, 16, False)),
                 ("granite-3-8b", "train_4k", (16, 16, False)),
                 ("granite-3-8b", "decode_32k", (32, 1, False)),
                 ("deepseek-v3-671b", "train_4k", (32, 16, True)),
                 ("mamba2-780m", "long_500k", (1, 1, False)),
                 ("qwen1.5-110b", "decode_32k", (1, 1, False))]   # infeasible: pruned


def backends(arch, shape_id, plan):
    return (tcm.GPUCostBackend(get_config(arch), shape_id, tcm.MeshPlan(*plan), TPU_CHIP),
            jcm.TPUCostBackend(jax_config(arch), shape_id, jcm.MeshPlan(*plan)))


@pytest.mark.parametrize("arch, shape_id, plan", BACKEND_CASES)
def test_gpu_cost_backend_matches_tpu_cost_backend(arch, shape_id, plan):
    """The same design space, and every point's feasibility and ``Estimate``
    (each field, and the resources) equal."""
    got_b, want_b = backends(arch, shape_id, plan)
    assert got_b.space() == want_b.space()
    for point in DesignSpace(got_b.space()):
        assert got_b.feasible(point) == want_b.feasible(point)
        got, want = got_b.evaluate(point), want_b.evaluate(point)
        for field in ESTIMATE_FIELDS:
            close(getattr(got, field), getattr(want, field), f"{point} {field}")
        close(dict(got.resources), dict(want.resources), f"{point} resources")


GENERATOR_APPS = {
    "pod-serve": lambda c: c.ApplicationSpec(name="pod-serve", goal="energy_efficiency",
                                             period_s=2.0, max_latency_s=1.0),
    "latency": lambda c: c.ApplicationSpec(name="latency", goal="latency",
                                           max_latency_s=1.0, max_act_error=5e-3),
    "continuous": lambda c: c.scenario_continuous_throughput(),
}


@pytest.mark.parametrize("app", sorted(GENERATOR_APPS))
@pytest.mark.parametrize("arch, shape_id, plan", BACKEND_CASES)
def test_generator_over_gpu_backend_matches_the_reference(arch, shape_id, plan, app):
    """The Generator's exhaustive search: the best point and strategy, the
    ranking with its scores, and the pruned points with their reasons."""
    got_b, want_b = backends(arch, shape_id, plan)
    got = tgen.Generator(got_b, GENERATOR_APPS[app](tcons)).search(
        method="exhaustive", refine=False)
    want = jgen.Generator(want_b, GENERATOR_APPS[app](jcons)).search(
        method="exhaustive", refine=False)
    assert (got.visited, got.space_size) == (want.visited, want.space_size)
    assert [(p.values, why) for p, why in got.pruned] == \
        [(p.values, why) for p, why in want.pruned]
    assert [(c.point.values, c.strategy) for c in got.ranked] == \
        [(c.point.values, c.strategy) for c in want.ranked]
    for g, w in zip(got.ranked, want.ranked):
        close(g.score, w.score, "score")
    if want.ranked:
        assert got.best.point.values == want.best.point.values


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape_id", sorted(SHAPES))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_mode_prints_the_references_lines(arch, shape_id, multi_pod):
    """``launch/train.py``'s plan at the reference's constants prints the
    reference's five lines, character for character."""
    got, want = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(got):
        tlaunch.plan(arch, shape_id, multi_pod, chip=TPU_CHIP)
    with contextlib.redirect_stdout(want):
        jlaunch.plan(arch, shape_id, multi_pod)
    assert len(want.getvalue().splitlines()) == 5
    assert got.getvalue() == want.getvalue()


def test_plan_mode_runs_from_the_command_line_on_the_h100(capsys):
    """``python -m repro_torch.launch.train --arch granite-3-8b --shape
    train_4k``: the plan on ``H100Chip``, whose compute term is the
    reference's scaled by the ratio of the bf16 peaks."""
    assert tlaunch.main(["--arch", "granite-3-8b", "--shape", "train_4k", "--multi-pod"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=granite-3-8b shape=train_4k chips=512 (dp=32 tp=16 fsdp=False)"
    r = tcm.estimate_step(get_config("granite-3-8b"), "train_4k", tcm.MeshPlan(32, 16))
    want = jcm.estimate_step(jax_config("granite-3-8b"), "train_4k", jcm.MeshPlan(32, 16))
    close(r.compute_s, want.compute_s * TPU.peak_flops / DEFAULT_CHIP.peak_flops)
    close(r.memory_s, want.memory_s * TPU.hbm_bw / DEFAULT_CHIP.hbm_bw)
    close(r.collective_s, want.collective_s * TPU.ici_bw / DEFAULT_CHIP.link_bw)
    assert f"compute={r.compute_s:.3f}s" in out[3]
