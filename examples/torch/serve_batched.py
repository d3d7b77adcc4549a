"""Sweep-service demo: concurrent what-if queries, micro-batched.

N client threads fire design-space queries at one persistent
:class:`~repro_torch.dse.service.SweepService` -- duplicate and repeat
queries included, the access pattern of an interactive exploration
session.  The service coalesces concurrent duplicates, groups points
that share a mapping signature into one batched analytic evaluation,
and serves repeats from the content-addressed result cache.

    PYTHONPATH=src python examples/torch/serve_batched.py [--clients 8] [--device cpu]

The PyTorch port's service over an analytic engine (host numpy; the
first query primes its density calibration).  ``--device`` names the
device of the engine's seams should it run the vector backend (default:
the CUDA device).
"""
import argparse
import random
import threading
import time

import numpy as np

from repro_torch.dse import DesignSpace, ResultCache, SweepEngine, SweepService


def workload(m: int = 96, k: int = 96, n: int = 96,
             da: float = 0.12, db: float = 0.12):
    rng = np.random.default_rng(0)
    a = rng.random((k, m)) * (rng.random((k, m)) < da)
    b = rng.random((k, n)) * (rng.random((k, n)) < db)
    return ({"A": a, "B": b},
            {"M": m, "K": k, "N": n})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--queries", type=int, default=12,
                    help="queries per client")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    inputs, shapes = workload()
    space = DesignSpace("gamma", axes={
        "fibercache_mb": [0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 4.0]})
    points = space.grid()

    cache = ResultCache()
    engine = SweepEngine(inputs, shapes, backend="analytic",
                         result_cache=cache, device=args.device)
    engine.prime(points[0])

    results = {}
    lock = threading.Lock()

    def client(cid: int, svc: SweepService) -> None:
        rng = random.Random(args.seed + cid)
        for _ in range(args.queries):
            res = svc.what_if(rng.choice(points), timeout=60)
            assert res.ok, res.error
            with lock:
                results.setdefault(res.label, set()).add(
                    (res.seconds, res.energy_pj, res.dram_bytes))
            time.sleep(rng.random() * 0.002)

    t0 = time.perf_counter()
    with SweepService(engine, max_batch=32,
                      batch_window_s=0.005) as svc:
        threads = [threading.Thread(target=client, args=(i, svc))
                   for i in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = svc.stats()
    dt = time.perf_counter() - t0

    total = args.clients * args.queries
    # every client observed bit-identical objectives per configuration
    assert all(len(v) == 1 for v in results.values())
    cs = cache.stats()
    print(f"queries      {total} from {args.clients} clients "
          f"in {dt:.2f}s ({total / dt:.0f} qps)")
    print(f"batches      {stats['batches']} "
          f"(mean {total / max(stats['batches'], 1):.1f} requests/batch, "
          f"{stats['coalesced']} coalesced in-flight)")
    print(f"result cache {cs['hits']} hits / {cs['misses']} misses "
          f"({cs['entries']} entries) -- "
          f"{total - cs['misses']} of {total} queries served "
          f"without the analytic backend")
    print(f"distinct configurations evaluated: {len(results)}")


if __name__ == "__main__":
    main()
