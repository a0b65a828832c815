"""Quickstart on the PyTorch/CUDA port: the full paper flow in one minute.

1. Reproduce the paper's LSTM accelerator numbers (C1/C2) from the
   analytical RTL-template models.
2. Reproduce the workload-strategy results (C3/C4); C4's learnable threshold
   trains on ``--device``.
3. Run the Generator (the paper's §4 goal): application-specific knowledge
   in → best (design × strategy) out — on BOTH hardware backends: the FPGA
   and the GPU backend (``GPUCostBackend``: granite-3-8b serving decode_32k
   on a 16 x 16 mesh of H100s, costed on ``H100Chip``).

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.constraints import ApplicationSpec, scenario_regular_sensor
from repro_torch.core.cost_model import GPUCostBackend, MeshPlan
from repro_torch.core.fpga import (FPGACostBackend, baseline_template, optimized_template,
                                   paper_workload)
from repro_torch.core.generator import Generator
from repro_torch.core.workload import AccelProfile, c3_ratio, c4_improvement


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="where the learnable threshold trains: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    # -- 1. RTL templates (RQ1): the paper's C1/C2 ---------------------------
    w = paper_workload()
    base, opt = baseline_template(), optimized_template()
    print("== C1/C2: LSTM RTL-template optimization ==")
    print(f"latency : {base.latency_s(w) * 1e6:.2f} -> {opt.latency_s(w) * 1e6:.2f} µs "
          f"(published 53.32 -> 28.07)")
    print(f"GOPS/s/W: {base.gops_per_w(w):.2f} -> {opt.gops_per_w(w):.2f} "
          f"({opt.gops_per_w(w) / base.gops_per_w(w):.2f}x, published 2.33x)")

    # -- 2. Workload-aware strategies (RQ2): C3/C4 ----------------------------
    prof = AccelProfile.from_template(opt, w)
    print("\n== C3: Idle-Waiting vs On-Off at 40 ms ==")
    print(f"items in the same energy budget: {c3_ratio(prof, 0.040):.2f}x (published 12.39x)")
    print("\n== C4: learnable vs predefined switching threshold ==")
    res = c4_improvement(prof, device=args.device)
    print(f"improvement: +{res['improvement'] * 100:.1f}% (published ~6%)")

    # -- 3. The Generator (RQ3): application knowledge -> accelerator ---------
    print("\n== Generator on the FPGA backend (40 ms sensor scenario) ==")
    app = scenario_regular_sensor(0.040)
    result = Generator(FPGACostBackend(workload=w), app, device=args.device).search(
        method="exhaustive")
    print(result.report(top=3))

    print("\n== Generator on the GPU backend (beyond-paper: cluster serving) ==")
    cfg = get_config("granite-3-8b")
    backend = GPUCostBackend(cfg, "decode_32k", MeshPlan(dp=16, tp=16))
    app = ApplicationSpec(name="cluster-serve", goal="energy_efficiency",
                          period_s=2.0, max_latency_s=1.0)
    result = Generator(backend, app, device=args.device).search(method="exhaustive",
                                                                refine=False)
    print(result.report(top=3))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
