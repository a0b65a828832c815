"""End-to-end RQ3 on the PyTorch/CUDA port: derive the most
energy-efficient accelerator for a user-described application, then VALIDATE
the choice by simulation — the paper's progressive-evaluation loop
(standalone inputs → combination).

Scenario: an IoT vibration sensor fires irregularly (bursty), the deadline
is 10 ms, and the deployment must fit a Spartan-7 XC7S15.  The Generator's
learnable switching threshold trains on ``--device``.

Run:  PYTHONPATH=src python examples/torch/generate_accelerator.py [--device cpu]
"""
import argparse

from repro_torch.core.candidates import DesignPoint
from repro_torch.core.constraints import ApplicationSpec
from repro_torch.core.fpga import FPGACostBackend, optimized_template, paper_workload
from repro_torch.core.generator import Generator, profile_of, score_candidate
from repro_torch.core.workload import AccelProfile, bursty_trace, simulate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="where the learnable threshold trains: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    w = paper_workload()
    backend = FPGACostBackend(workload=w)

    # -- application-specific knowledge ---------------------------------------
    probe = AccelProfile.from_template(optimized_template(), w)
    gaps = bursty_trace(probe, n=3000, seed=7)
    app = ApplicationSpec(
        name="vibration-sensor",
        goal="energy_efficiency",
        max_latency_s=10e-3,
        max_act_error=5e-3,  # no QAT retraining budget → 'hard' variants excluded
        resource_budget={"lut": 8000, "bram_kb": 360},
        gaps=gaps,
    )
    print(f"application: {app.name}, deadline {app.max_latency_s * 1e3:.0f} ms, "
          f"act-error bound {app.max_act_error}, {len(gaps)} bursty requests")

    # -- standalone input evaluation (paper §2.3) -----------------------------
    print("\n[1] RTL templates alone (continuous duty, app-blind):")
    cont = ApplicationSpec(name="cont", goal="gops_per_w")
    best_hw = Generator(backend, cont, device=args.device).search(refine=False).best
    ok, why = app.check(best_hw.point, best_hw.estimate)
    print(f"    best template: {best_hw.point} -> {best_hw.score:.2f} GOPS/W")
    print(f"    ...but under THIS application it is "
          f"{'feasible' if ok else f'INFEASIBLE ({why})'}")

    print("[2] workload strategies alone (fixed paper-optimized template):")
    opt = optimized_template()
    paper_point = DesignPoint.of(n_mac=opt.n_mac, n_act=opt.n_act,
                                 act_impl=opt.act_impl, pipelined=opt.pipelined)
    fixed = score_candidate(paper_point, backend.evaluate(paper_point), app)
    print(f"    best strategy on paper template: {fixed.strategy} "
          f"-> {fixed.score:.2f} items/J")

    # -- combined optimization (RQ3) ------------------------------------------
    print("[3] combined Generator search (templates x strategies):")
    res = Generator(backend, app, device=args.device).search(method="exhaustive")
    best = res.best
    print(f"    {best.describe()}")
    print(f"    searched {res.visited}/{res.space_size}, pruned {len(res.pruned)} "
          f"(first prune reason: {res.pruned[0][1] if res.pruned else '-'})")

    gain = best.score / fixed.score
    print(f"\ncombined vs paper-template-with-best-strategy: {gain:.2f}x; "
          f"and the app-blind template was {'feasible' if ok else 'infeasible'} — "
          f"application-specific knowledge changed the design (RQ3).")

    # -- validation by simulation ---------------------------------------------
    prof = profile_of(best.estimate)
    sim = simulate(gaps, best.strategy, prof, tau=best.tau,
                   max_stretch=app.max_latency_s - best.estimate.latency_s)
    print(f"validation: {sim.items} items, {sim.energy_j:.1f} J, "
          f"{sim.items_per_joule:.2f} items/J, {sim.missed_deadlines} deadline misses")
    if not abs(sim.items_per_joule - best.score) / best.score < 0.05:
        raise RuntimeError(f"simulated {sim.items_per_joule} items/J against the "
                           f"estimate's {best.score}")
    print("analytical estimate matches simulation within 5% ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
