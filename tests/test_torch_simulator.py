"""The port's simulator against the reference simulator.

The five paper designs at 32^3 (density 0.2) and the natively-vectorized
zoo cascades run through the port on ``device='cpu'`` (the kernels'
plain versions) and through the reference's ``python`` and ``vector``
backends, on the same reference inputs carried across with
``repro_torch.carry``.  Outputs are bit-identical, instrumentation
counters equal, no Einsum falls back and no seam downgrades; the
``Report`` equals the reference vector backend's (the interpreter feeds
the performance model per element, so its Report is not the target).
"""
import dataclasses

import numpy as np
import pytest

from repro.accelerators import REGISTRY as REF_REGISTRY
from repro.accelerators import DEFAULT_PARAMS as REF_PARAMS
from repro.accelerators.zoo import ZOO as REF_ZOO
from repro.core.csf import CSF as RefCSF
from repro.core.generator import CascadeSimulator as RefSimulator
from repro.core.trace import CollectingInstr as RefInstr
from repro.core.vectorized import VectorBackend as RefVectorBackend
from repro_torch import accelerators as port
from repro_torch.accelerators.zoo import ZOO
from repro_torch.carry import carry
from repro_torch.core.einsum import Semiring
from repro_torch.core.generator import CascadeSimulator
from repro_torch.core.trace import CollectingInstr
from repro_torch.core.vectorized import VectorBackend
from repro_torch.core.vplan import _Unsupported
from repro_torch.kernels.backends import CudaKernels, GuardedKernels

from test_backends import COUNTERS, NATIVE_ZOO, _zoo_inputs

DESIGNS = ("outerspace", "extensor", "gamma", "sigma", "matraptor")


def _ref_inputs(spec, inputs, params):
    """The reference's own input fibertrees (what its simulator builds
    from dense arrays), so both packages start from one object."""
    sim = RefSimulator(spec, params=params, model=False)
    return {k: sim._to_ftensor(k, v) for k, v in inputs.items()}


def _report_fields(report):
    d = dataclasses.asdict(report)
    d.pop("stage_seconds")                   # host wall clock
    return d


def _check(ref_spec, port_spec, inputs, shapes, params):
    ref_in = _ref_inputs(ref_spec, inputs, params)
    port_in = {k: carry(v) for k, v in ref_in.items()}
    runs = {}
    for label, sim_cls, instr_cls, spec, ins, backend in (
            ("python", RefSimulator, RefInstr, ref_spec, ref_in, "python"),
            ("vector", RefSimulator, RefInstr, ref_spec, ref_in,
             RefVectorBackend(kernel_backend="numpy")),
            ("port", CascadeSimulator, CollectingInstr, port_spec, port_in,
             VectorBackend(device="cpu"))):
        ci = instr_cls()
        sim = sim_cls(spec, params=params, extra_instr=ci, backend=backend)
        runs[label] = (sim.run(dict(ins), shapes), ci)
    res, ci = runs["port"]
    assert res.fallback_reasons == {}
    assert res.downgrade_events == {}
    assert res.report.fallback_reasons == {}
    for label in ("python", "vector"):
        ref_res, ref_ci = runs[label]
        assert set(res.tensors) == set(ref_res.tensors)
        for name in ref_res.tensors:
            want, got = ref_res[name], res[name]
            assert got.ranks == want.ranks, name
            assert list(got.iter_leaves()) == list(want.iter_leaves()), \
                f"{label}: {name} not bit-identical"
            assert np.array_equal(got.to_dense(), want.to_dense())
        for attr in COUNTERS + ("merges",):
            assert getattr(ci, attr) == getattr(ref_ci, attr), \
                f"{label}: {attr} differ"
    assert _report_fields(res.report) == \
        _report_fields(runs["vector"][0].report)


@pytest.mark.parametrize("design", DESIGNS)
def test_design_matches_reference(design):
    rng = np.random.default_rng(0)
    n = 32
    a = rng.random((n, n)) * (rng.random((n, n)) < 0.2)
    b = rng.random((n, n)) * (rng.random((n, n)) < 0.2)
    _check(REF_REGISTRY[design](), port.REGISTRY[design](),
           {"A": a, "B": b}, {"m": n, "k": n, "n": n},
           REF_PARAMS.get(design))


@pytest.mark.parametrize("name", NATIVE_ZOO)
def test_zoo_cascade_matches_reference(name):
    inputs, shapes = _zoo_inputs(name, np.random.default_rng(3))
    _check(REF_ZOO[name](), ZOO[name](), inputs, shapes, None)


def test_simulate_entry_point_on_cpu():
    """``simulate`` by registry name, on the CPU, equals the reference."""
    rng = np.random.default_rng(4)
    a = rng.random((24, 24)) * (rng.random((24, 24)) < 0.2)
    b = rng.random((24, 24)) * (rng.random((24, 24)) < 0.2)
    shapes = {"m": 24, "k": 24, "n": 24}
    from repro.accelerators import simulate as ref_simulate
    want = ref_simulate("gamma", {"A": a, "B": b}, shapes, backend="vector")
    got = port.simulate("gamma", {"A": a, "B": b}, shapes, device="cpu")
    assert np.array_equal(got["Z"].to_dense(), want["Z"].to_dense())
    assert got.report.seconds == want.report.seconds
    assert got.fallback_reasons == {} and got.downgrade_events == {}


def test_carry_csf_round_trip():
    rng = np.random.default_rng(6)
    dense = rng.random((9, 7)) * (rng.random((9, 7)) < 0.3)
    ref = RefCSF.from_dense("A", ["M", "K"], dense) \
        .partition_uniform_occupancy("K", 3)
    got = carry(ref)
    assert got.ranks == ref.ranks and got.upper_ranks == ref.upper_ranks
    assert got.rank_shapes == ref.rank_shapes
    for gc, rc in zip(got.coords, ref.coords):
        assert np.array_equal(gc, rc)
    assert np.array_equal(got.values, ref.values)
    assert list(got.to_ftensor().iter_leaves()) == \
        list(ref.to_ftensor().iter_leaves())


def test_carry_dense_and_leaf_paths_agree():
    from repro.core.fibertree import FTensor as RefFTensor
    from repro_torch.carry import ftensor_from_dense
    rng = np.random.default_rng(7)
    dense = rng.random((6, 5, 4)) * (rng.random((6, 5, 4)) < 0.3)
    ranks = ["I", "J", "K"]
    ref = RefFTensor.from_dense("T", ranks, dense).swizzle(["K", "I", "J"])
    got = carry(ref)
    assert got.ranks == ref.ranks and got.rank_shapes == ref.rank_shapes
    assert list(got.iter_leaves()) == list(ref.iter_leaves())
    direct = ftensor_from_dense("T", ranks, dense)
    assert list(direct.iter_leaves()) == \
        list(RefFTensor.from_dense("T", ranks, dense).iter_leaves())
    assert np.array_equal(direct.to_dense(), dense)


def test_cpu_keeps_the_oracle_fallback():
    """On the CPU an interpreter-only semiring still reruns on the
    oracle, with the reason surfaced."""
    rng = np.random.default_rng(8)
    a = rng.random((12, 12)) * (rng.random((12, 12)) < 0.3)
    scalar_only = Semiring(add=min, mul=lambda x, y: x + y,
                           add_identity=float("inf"), name="scalar_min")
    sim = CascadeSimulator(ZOO["rowwise-spmspm"](), semiring=scalar_only,
                           backend=VectorBackend(device="cpu"))
    res = sim.run({"A": a, "B": a}, {"m": 12, "k": 12, "n": 12})
    assert set(res.fallback_reasons) == {"Z"}


def test_cuda_backend_never_falls_back():
    """A CUDA backend selects the hand kernels and has no oracle rerun:
    a plan outside the IR raises (before any kernel is needed, so this
    runs without a card)."""
    vb = VectorBackend(device="cuda")
    assert vb.fallback is False
    assert isinstance(vb.kernels, GuardedKernels)
    assert isinstance(vb.kernels.backend, CudaKernels)
    rng = np.random.default_rng(9)
    a = rng.random((12, 12)) * (rng.random((12, 12)) < 0.3)
    scalar_only = Semiring(add=min, mul=lambda x, y: x + y,
                           add_identity=float("inf"), name="scalar_min")
    sim = CascadeSimulator(ZOO["rowwise-spmspm"](), semiring=scalar_only,
                           backend=vb)
    with pytest.raises(_Unsupported):
        sim.run({"A": a, "B": a}, {"m": 12, "k": 12, "n": 12})
