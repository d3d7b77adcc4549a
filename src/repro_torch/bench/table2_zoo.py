"""Table 2: the cascade zoo -- every published cascade form compiles
through the TeAAL pipeline and evaluates correctly vs the dense oracle
(including the Toeplitz == direct-convolution equivalence), on the port
(``benchmarks/table2_zoo.py``, copied).  Its rows are validity flags,
the same on either backend."""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from repro_torch.accelerators.zoo import ZOO
from repro_torch.core.einsum import dense_reference
from repro_torch.core.generator import CascadeSimulator
from repro_torch.core.vectorized import VectorBackend
from repro_torch.kernels.backends import resolve_device


def _inputs(name, rng):
    if name in ("eyeriss-conv", "toeplitz-conv"):
        shapes = {"b": 2, "c": 3, "h": 6, "w": 6, "m": 4, "r": 3, "s": 3,
                  "p": 4, "q": 4}
        return {"I": rng.random((2, 3, 6, 6)) *
                (rng.random((2, 3, 6, 6)) < .5),
                "F": rng.random((3, 4, 3, 3))}, shapes
    if name in ("tensaurus-mttkrp", "factorized-mttkrp"):
        shapes = {"i": 5, "j": 4, "k": 3, "r": 6}
        return {"T": rng.random((5, 4, 3)) *
                (rng.random((5, 4, 3)) < 0.4),
                "A": rng.random((3, 6)), "B": rng.random((4, 6))}, shapes
    if name == "fft-step":
        shapes = {"u": 1, "k0": 4, "n1": 2, "v": 2}
        return {"P": rng.random((1, 4, 2, 2)),
                "X": rng.random((2, 2))}, shapes
    if name in ("rowwise-spmspm", "sparse-add"):
        shapes = {"m": 24, "k": 24, "n": 24}
        return {"A": rng.random((24, 24)) * (rng.random((24, 24)) < 0.2),
                "B": rng.random((24, 24)) *
                (rng.random((24, 24)) < 0.2)}, shapes
    if name in ("elementwise-3way", "sparse-add-3way"):
        shapes = {"m": 24, "n": 24}

        def sp():
            return rng.random((24, 24)) * (rng.random((24, 24)) < 0.3)
        return {"A": sp(), "B": sp(), "C": sp()}, shapes
    if name == "broadcast-outer":
        shapes = {"m": 24, "n": 8}
        return {"A": rng.random(24) * (rng.random(24) < 0.5),
                "B": rng.random(24) * (rng.random(24) < 0.5)}, shapes
    raise KeyError(name)


def run(backend: str = "vector", device=None
        ) -> List[Tuple[str, float, float]]:
    """Every zoo cascade on ``backend`` ('vector': its seams on
    ``device``, None meaning the CUDA device; 'python': the interpreter)
    against the dense oracle: CSV rows (name, us, 1.0 / 0.0)."""
    device = resolve_device(device)
    rows = []
    all_ok = True
    for name in sorted(ZOO):
        rng = np.random.default_rng(0)
        spec = ZOO[name]()
        inputs, shapes = _inputs(name, rng)
        t0 = time.time()
        sim = CascadeSimulator(spec, model=False, backend=(
            VectorBackend(device=device) if backend == "vector"
            else backend))
        res = sim.run(dict(inputs), shapes)
        us = (time.time() - t0) * 1e6

        dense = {k: np.asarray(v) for k, v in inputs.items()}
        ok = True
        for e in spec.einsum.expressions:
            dense[e.output.tensor] = dense_reference(
                e, dense, {k.upper(): v for k, v in shapes.items()})
            out = e.output.tensor
            got = res.tensors[out].to_dense()
            decl = spec.einsum.declaration[out]
            order = spec.mapping.rank_order.get(out, decl)
            want = np.transpose(dense[out],
                                [decl.index(r) for r in order])
            pad = np.zeros(want.shape)
            pad[tuple(slice(0, s) for s in got.shape)] = got
            ok = ok and bool(np.allclose(pad, want))
        all_ok = all_ok and ok
        rows.append((f"table2/{name}", us, float(ok)))
    rows.append(("table2/claim/all_cascades_validate", 0.0,
                 float(all_ok)))
    return rows
