"""Design-space study (the paper's Sec.-8 workflow): sweep point
changes to an accelerator's TeAAL spec and compare modeled designs --
now driven by the DSE engine (``repro_torch.dse``), which evaluates sweep
points through the analytic backend by default: density calibration is
done once per workload, and every sweep point after that is a
closed-form evaluation (~100-200x the points/sec of execution-based
simulation, see BENCH_dse.json).

Three studies on the same SpMSpM workload:
  1. Gamma's FiberCache capacity (locality vs area) + Pareto frontier,
  2. Gamma's merger radix (swizzle throughput vs comparator area),
  3. the OuterSPACE-vs-Gamma-vs-ExTensor cross-design comparison --
all from declarative specs, no simulator code written.

    PYTHONPATH=src python examples/torch/design_space_study.py [--backend B] [--device cpu]

The PyTorch port's DSE engine: the analytic backend is host numpy; a
'vector' engine runs its seams on the CUDA device unless ``--device``
names another.
"""
import argparse

import numpy as np

from repro_torch.dse import DesignPoint, DesignSpace, SweepEngine, pareto_front


def workload(seed=0, m=96, k=96, n=96, da=0.12, db=0.12):
    rng = np.random.default_rng(seed)
    a = rng.random((k, m)) * (rng.random((k, m)) < da)
    b = rng.random((k, n)) * (rng.random((k, n)) < db)
    return {"A": a, "B": b}, {"m": m, "k": k, "n": n}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="analytic",
                    choices=["analytic", "vector", "python"],
                    help="evaluation engine (analytic = closed-form)")
    ap.add_argument("--device", default=None,
                    help="torch device of a 'vector' engine's seams "
                         "(default: the CUDA device)")
    args = ap.parse_args()

    inputs, shapes = workload()
    engine = SweepEngine(inputs, shapes, backend=args.backend,
                         device=args.device)

    print(f"=== sweep 1: Gamma FiberCache capacity "
          f"[backend={args.backend}] ===")
    print("  (below ~0.005 MB the B rows stop fitting: traffic rises)")
    space = DesignSpace("gamma", axes={
        "fibercache_mb": [0.001, 0.002, 0.005, 0.02, 0.25, 3.0]})
    results = engine.sweep(space.grid())
    for r in results:
        print("  " + r.row())
    front = pareto_front([r for r in results if r.ok])
    print("  pareto frontier (time/energy/traffic): "
          + ", ".join(r.label for r in front))

    print("\n=== sweep 2: Gamma merger radix ===")
    print("  (radix trades comparator area against K1 round "
          "parallelism: the radix is also the K-fiber group size, "
          "paper Fig. 8a)")
    radix_space = DesignSpace("gamma", axes={"merge_radix": [2, 8, 64]})
    for r in engine.sweep(radix_space.grid()):
        print("  " + r.row())

    print("\n=== cross-design comparison (same workload) ===")
    designs = [DesignPoint.make("outerspace"),
               DesignPoint.make("gamma"),
               DesignPoint.make("extensor")]
    results = engine.sweep(designs)
    for r in results:
        note = ""
        if r.ok and r.fallback_reasons:
            note = ("  [oracle fallback: "
                    + "; ".join(f"{k}: {v}"
                                for k, v in r.fallback_reasons.items())
                    + "]")
        print("  " + r.row() + note)
    front = pareto_front([r for r in results if r.ok])
    print("  pareto frontier: " + ", ".join(r.label for r in front))
    print(f"\n  {engine.points_evaluated} points evaluated, "
          f"{engine.plan_cache_hits} plan-cache hits")


if __name__ == "__main__":
    main()
