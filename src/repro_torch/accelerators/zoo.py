"""The Table 2 cascade zoo: Einsum cascades for accelerators/algorithms
beyond the four validated designs.  Each entry is a minimal spec
(einsum + default mapping) used to demonstrate the expressive range of
cascades-of-Einsums and to drive the benchmark that checks every
cascade evaluates correctly against the dense oracle.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.spec import AcceleratorSpec, load_spec


def eyeriss_conv() -> AcceleratorSpec:
    """Eyeriss CONV (Table 2): O[b,m,p,q] = I[b,c,p+r,q+s] * F[c,m,r,s]."""
    return load_spec({
        "name": "Eyeriss-CONV",
        "einsum": {
            "declaration": {
                "I": ["B", "C", "H", "W"],
                "F": ["C", "M", "R", "S"],
                "O": ["B", "M", "P", "Q"],
            },
            "expressions": [
                "O[b, m, p, q] = I[b, c, p + r, q + s] * F[c, m, r, s]",
            ],
        },
        "mapping": {},
    })


def toeplitz_conv() -> AcceleratorSpec:
    """Toeplitz expansion / im2col + matmul (Table 2), 2D."""
    return load_spec({
        "name": "Toeplitz-CONV",
        "einsum": {
            "declaration": {
                "I": ["B", "C", "H", "W"],
                "F": ["C", "M", "R", "S"],
                "T": ["B", "C", "P", "Q", "R", "S"],
                "O": ["B", "M", "P", "Q"],
            },
            "expressions": [
                "T[b, c, p, q, r, s] = I[b, c, p + r, q + s]",
                "O[b, m, p, q] = T[b, c, p, q, r, s] * F[c, m, r, s]",
            ],
        },
        "mapping": {},
    })


def tensaurus_mttkrp() -> AcceleratorSpec:
    """Tensaurus MTTKRP (Table 2): C[i,r] = T[i,j,k] * B[j,r] * A[k,r]."""
    return load_spec({
        "name": "Tensaurus-MTTKRP",
        "einsum": {
            "declaration": {
                "T": ["I", "J", "K"],
                "A": ["K", "R"],
                "B": ["J", "R"],
                "C": ["I", "R"],
            },
            "expressions": ["C[i, r] = T[i, j, k] * B[j, r] * A[k, r]"],
        },
        "mapping": {
            "loop-order": {"C": ["I", "J", "K", "R"]},
        },
    })


def factorized_mttkrp() -> AcceleratorSpec:
    """Factorized MTTKRP (Table 2): two-stage cascade."""
    return load_spec({
        "name": "Factorized-MTTKRP",
        "einsum": {
            "declaration": {
                "T": ["I", "J", "K"],
                "A": ["K", "R"],
                "B": ["J", "R"],
                "S": ["I", "J", "R"],
                "C": ["I", "R"],
            },
            "expressions": [
                "S[i, j, r] = T[i, j, k] * A[k, r]",
                "C[i, r] = S[i, j, r] * B[j, r]",
            ],
        },
        "mapping": {
            "loop-order": {"S": ["I", "J", "K", "R"],
                           "C": ["I", "J", "R"]},
        },
    })


def cooley_tukey_step() -> AcceleratorSpec:
    """One Cooley-Tukey FFT butterfly step (Table 2).

    E/O are the even/odd DFT halves; P holds twiddle factors.  Uses real
    arithmetic (the butterfly structure is what the cascade expresses).
    """
    return load_spec({
        "name": "FFT-Step",
        "einsum": {
            "declaration": {
                "P": ["U", "K0", "N1", "V"],
                "X": ["N1", "V"],
                "E": ["U", "K0"],
                "O": ["U", "K0"],
                "T": ["K0"],
                "Y0": ["K0"],
                "Y1": ["K0"],
            },
            "expressions": [
                "E[0, k0] = P[0, k0, n1, 0] * X[n1, 0]",
                "O[0, k0] = P[0, k0, n1, 0] * X[n1, 1]",
                "T[k0] = P[0, k0, 0, 1] * O[0, k0]",
                "Y0[k0] = E[0, k0] + T[k0]",
                "Y1[k0] = E[0, k0] - T[k0]",
            ],
        },
        "mapping": {},
    })


def rowwise_spmspm() -> AcceleratorSpec:
    """Unpartitioned Gustavson SpMSpM: the canonical workload of the
    vectorized (CSF) execution backend -- every rank co-iterates, so
    the whole loop nest runs on the columnar fast path."""
    return load_spec({
        "name": "Rowwise-SpMSpM",
        "einsum": {
            "declaration": {
                "A": ["M", "K"],
                "B": ["K", "N"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[m, k] * B[k, n]"],
        },
        "mapping": {
            "loop-order": {"Z": ["M", "K", "N"]},
        },
    })


def sparse_add() -> AcceleratorSpec:
    """Elementwise sparse addition: exercises union (merge) co-iteration
    in both backends (the sorted-union kernel on the vector path)."""
    return load_spec({
        "name": "Sparse-Add",
        "einsum": {
            "declaration": {
                "A": ["M", "N"],
                "B": ["M", "N"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[m, n] + B[m, n]"],
        },
        "mapping": {},
    })


def elementwise_3way() -> AcceleratorSpec:
    """Three-factor elementwise product: every rank co-iterates three
    drivers, exercising the nested (left-leaning) two-finger
    intersection chain and its lazy-pull instrumentation accounting on
    the vector path."""
    return load_spec({
        "name": "Elementwise-3way",
        "einsum": {
            "declaration": {
                "A": ["M", "N"],
                "B": ["M", "N"],
                "C": ["M", "N"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[m, n] * B[m, n] * C[m, n]"],
        },
        "mapping": {},
    })


def sparse_add_3way() -> AcceleratorSpec:
    """Three-term elementwise sum: the k-ary sorted multi-way merge
    (``kernels.ops.union_k_keys``) on the vector path."""
    return load_spec({
        "name": "Sparse-Add-3way",
        "einsum": {
            "declaration": {
                "A": ["M", "N"],
                "B": ["M", "N"],
                "C": ["M", "N"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[m, n] + B[m, n] + C[m, n]"],
        },
        "mapping": {},
    })


def broadcast_outer() -> AcceleratorSpec:
    """Broadcast along a driverless (dense) output rank: no input has
    an N rank, so the N loop enumerates the full coordinate range
    (``DenseEnumerate`` on the vector path)."""
    return load_spec({
        "name": "Broadcast-Outer",
        "einsum": {
            "declaration": {
                "A": ["M"],
                "B": ["M"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[m] * B[m]"],
        },
        "mapping": {},
    })


ZOO: Dict[str, Any] = {
    "eyeriss-conv": eyeriss_conv,
    "toeplitz-conv": toeplitz_conv,
    "tensaurus-mttkrp": tensaurus_mttkrp,
    "factorized-mttkrp": factorized_mttkrp,
    "fft-step": cooley_tukey_step,
    "rowwise-spmspm": rowwise_spmspm,
    "sparse-add": sparse_add,
    "elementwise-3way": elementwise_3way,
    "sparse-add-3way": sparse_add_3way,
    "broadcast-outer": broadcast_outer,
}
