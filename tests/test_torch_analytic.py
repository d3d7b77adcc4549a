"""The port's analytic backend and density models against the reference.

The same seeded numpy inputs go through both packages' ``AnalyticBackend``
(host numpy in both): ``Report`` fields, instrumentation counters, the
last Einsum's path and the per-Einsum fallback reasons are equal -- bit
for bit, no tolerance.  Cases: the reference's ``tests/test_analytic.py``
workloads, the five paper designs, Gamma across FiberCache capacities,
an affine (conv) plan, a cascade with a predicted intermediate, the
statistical modes and a semiring the model leaves to the interpreter.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.accelerators as RA
import repro.core.analytic as RAN
import repro.core.density as RD
from repro.accelerators.zoo import ZOO as RZOO
from repro.core.einsum import Semiring as RSemiring
from repro.core.generator import CascadeSimulator as RSim
from repro.core.mapping import MappingResolver as RResolver
from repro.core.spec import load_spec as rload
from repro.core.trace import CollectingInstr as RInstr

import repro_torch.accelerators as TA
import repro_torch.core.analytic as TAN
import repro_torch.core.density as TD
from repro_torch.accelerators.zoo import ZOO as TZOO
from repro_torch.core.einsum import Semiring as TSemiring
from repro_torch.core.generator import CascadeSimulator as TSim
from repro_torch.core.iteration import get_backend
from repro_torch.core.mapping import MappingResolver as TResolver
from repro_torch.core.spec import load_spec as tload
from repro_torch.core.trace import CollectingInstr as TInstr

REF = SimpleNamespace(A=RA, ZOO=RZOO, Sim=RSim, Instr=RInstr, load=rload,
                      Backend=RAN.AnalyticBackend, Semiring=RSemiring)
PORT = SimpleNamespace(A=TA, ZOO=TZOO, Sim=TSim, Instr=TInstr, load=tload,
                       Backend=TAN.AnalyticBackend, Semiring=TSemiring)

COUNTERS = ("touch_counts", "iter_counts", "compute_counts",
            "isect_steps", "isect_matches", "advances", "merges")
DESIGNS = ("outerspace", "extensor", "gamma", "sigma", "matraptor")


def _sp(rng, m, n, d):
    return rng.random((m, n)) * (rng.random((m, n)) < d)


def _square(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return ({"A": _sp(rng, n, n, d), "B": _sp(rng, n, n, d)},
            {"m": n, "k": n, "n": n})


def _row_sum(pkg):
    rng = np.random.default_rng(0)
    spec = pkg.load({
        "name": "RowSum",
        "einsum": {"declaration": {"A": ["M", "K"], "Y": ["M"]},
                   "expressions": ["Y[m] = A[m, k]"]},
        "mapping": {}})
    return spec, {"A": _sp(rng, 24, 24, 0.3)}, {"m": 24, "k": 24}, {}


def _broadcast(pkg):
    rng = np.random.default_rng(1)
    spec = pkg.load({
        "name": "Bcast",
        "einsum": {"declaration": {"A": ["N"], "Z": ["M", "N"]},
                   "expressions": ["Z[m, n] = A[n]"]},
        "mapping": {}})
    a = rng.random(12) * (rng.random(12) < 0.5)
    return spec, {"A": a}, {"m": 6, "n": 12}, {}


def _contract3(pkg):
    rng = np.random.default_rng(2)
    spec = pkg.load({
        "name": "Contract",
        "einsum": {"declaration": {"T": ["I", "J", "K"], "Y": ["I"]},
                   "expressions": ["Y[i] = T[i, j, k]"]},
        "mapping": {}})
    t = rng.random((6, 5, 4)) * (rng.random((6, 5, 4)) < 0.4)
    return spec, {"T": t}, {"i": 6, "j": 5, "k": 4}, {}


def _rowwise(pkg, n=64, d=0.3, **kw):
    inputs, shapes = _square(n, d, seed=3)
    return pkg.ZOO["rowwise-spmspm"](), inputs, shapes, kw


def _sparse_add(pkg):
    rng = np.random.default_rng(4)
    return (pkg.ZOO["sparse-add"](),
            {"A": _sp(rng, 32, 32, 0.25), "B": _sp(rng, 32, 32, 0.25)},
            {"m": 32, "n": 32}, {})


def _conv(pkg):
    rng = np.random.default_rng(5)
    inputs = {"I": rng.random((2, 3, 6, 6)) * (rng.random((2, 3, 6, 6))
                                               < .5),
              "F": rng.random((3, 4, 3, 3))}
    shapes = {"b": 2, "c": 3, "h": 6, "w": 6, "m": 4, "r": 3, "s": 3,
              "p": 4, "q": 4}
    return pkg.ZOO["eyeriss-conv"](), inputs, shapes, {}


def _mttkrp(pkg):
    rng = np.random.default_rng(6)
    t = rng.random((5, 4, 3)) * (rng.random((5, 4, 3)) < .4)
    inputs = {"T": t, "A": rng.random((3, 6)), "B": rng.random((4, 6))}
    return (pkg.ZOO["factorized-mttkrp"](), inputs,
            {"i": 5, "j": 4, "k": 3, "r": 6}, {})


def _scalar_min(pkg):
    """An interpreter-only semiring: the analytic model falls back to
    the interpreter for it and says why."""
    spec, inputs, shapes, _ = _rowwise(pkg, n=16)
    semiring = pkg.Semiring(add=min, mul=lambda x, y: x + y,
                            add_identity=float("inf"), name="scalar_min")
    return spec, inputs, shapes, {"semiring": semiring}


def _design(name, **spec_kw):
    def case(pkg):
        inputs, shapes = _square(96, 0.12, seed=7)
        spec = pkg.A.REGISTRY[name](**spec_kw)
        return spec, inputs, shapes, {"params": pkg.A.DEFAULT_PARAMS.get(
            name)}
    return case


CASES = {
    "row-sum": _row_sum, "broadcast": _broadcast, "contract-3": _contract3,
    "rowwise-spmspm": _rowwise, "sparse-add": _sparse_add,
    "eyeriss-conv": _conv, "factorized-mttkrp": _mttkrp,
    "uniform-mode": lambda pkg: _rowwise(pkg, n=48, d=0.2, mode="uniform"),
    "hypergeometric-mode": lambda pkg: _rowwise(
        pkg, n=48, d=0.2, mode="hypergeometric"),
    "scalar-min-semiring": _scalar_min,
    **{f"design-{d}": _design(d) for d in DESIGNS},
    **{f"gamma-{mb}MB": _design("gamma", fibercache_mb=mb)
       for mb in (0.001, 0.005, 3.0)},
}


#: the cases outside the analytic model in both packages, which run their
#: Einsums on the interpreter and say why
FALLS_BACK = {"scalar-min-semiring", "design-outerspace", "design-sigma"}


def _analytic_run(pkg, case):
    spec, inputs, shapes, kw = case(pkg)
    kw = dict(kw)
    params = kw.pop("params", None)
    semiring = kw.pop("semiring", None)
    backend = pkg.Backend(**kw)
    ci = pkg.Instr()
    sim = pkg.Sim(spec, params=params, semiring=semiring, model=True,
                  extra_instr=ci, backend=backend)
    res = sim.run(dict(inputs), shapes)
    return res, ci, backend


def _report(report):
    d = dataclasses.asdict(report)
    d.pop("stage_seconds")                   # host wall clock
    return d


@pytest.mark.parametrize("name", sorted(CASES))
def test_analytic_matches_reference(name):
    ref, ref_ci, ref_b = _analytic_run(REF, CASES[name])
    got, ci, b = _analytic_run(PORT, CASES[name])
    assert _report(got.report) == _report(ref.report)
    for attr in COUNTERS:
        assert getattr(ci, attr) == getattr(ref_ci, attr), attr
    assert got.fallback_reasons == ref.fallback_reasons
    assert b.last_path == ref_b.last_path
    assert bool(got.fallback_reasons) == (name in FALLS_BACK)
    if name not in FALLS_BACK:
        # the engine's defining property: no output data
        assert all(got[t].nnz == 0 for t in got.tensors
                   if t not in CASES[name](PORT)[1])


def test_densities_hint_matches_reference():
    """Data-free evaluation from declared densities (no tensor at all)."""
    outs = []
    for resolver, zoo, backend, instr in (
            (RResolver, RZOO, RAN.AnalyticBackend, RInstr),
            (TResolver, TZOO, TAN.AnalyticBackend, TInstr)):
        plan = resolver(zoo["rowwise-spmspm"]()).plan("Z")
        ci = instr()
        out = backend(mode="uniform", densities={"A": 0.1, "B": 0.1},
                      fallback=False).execute(
            plan, {}, {"m": 100, "k": 100, "n": 100}, instr=ci)
        outs.append((out.nnz, dict(ci.compute_counts),
                     dict(ci.touch_counts)))
    assert outs[0] == outs[1]
    assert outs[1][1][("Z", "mul")] == pytest.approx(1e4, rel=0.2)


def test_unsupported_plan_raises_without_fallback():
    spec, inputs, shapes, kw = _scalar_min(PORT)
    sim = TSim(spec, model=False, semiring=kw["semiring"],
               backend=TAN.AnalyticBackend(fallback=False))
    with pytest.raises(TAN._Unsupported):
        sim.run(inputs, shapes)


def test_iterative_cascades_reject_analytic():
    inputs, shapes = _square(8, 0.3)
    sim = TSim(TZOO["rowwise-spmspm"](), backend=TAN.AnalyticBackend())
    with pytest.raises(ValueError, match="materializes no output"):
        sim.run_iterative(inputs, carry={"A": "Z"}, done_when_empty="Z",
                          var_shapes=shapes)


def test_analytic_needs_no_device(monkeypatch):
    """The analytic backend is host numpy: ``simulate`` runs it with no
    card and no ``device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert isinstance(get_backend("analytic"), TAN.AnalyticBackend)
    inputs, shapes = _square(24, 0.2)
    got = TA.simulate("gamma", inputs, shapes, backend="analytic")
    ref = RA.simulate("gamma", inputs, shapes, backend="analytic")
    assert got.fallback_reasons == {}
    assert _report(got.report) == _report(ref.report)


# ---------------------------------------------------------------------- #
# density models
# ---------------------------------------------------------------------- #
def test_batched_stat_misses_matches_scalar_bitwise():
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = float(rng.integers(0, 10_000))
        unique = float(rng.integers(0, 5_000))
        nbytes = rng.choice([4.0, 8.0, 12.0, 16.0], size=17)
        caps = rng.choice([0.0, 64.0, 4096.0, 1e6, 1e9], size=17) * \
            rng.random(17)
        got = TD.batched_stat_misses(n, unique, nbytes, caps)
        want = [TD.stat_misses(n, unique, b, c) for b, c in zip(nbytes, caps)]
        assert got.tolist() == want
        assert got.tolist() == RD.batched_stat_misses(
            n, unique, nbytes, caps).tolist()


def test_density_models_match_reference():
    rng = np.random.default_rng(4)
    a = _sp(rng, 20, 30, 0.2)
    from repro.core.fibertree import FTensor as RF
    from repro_torch.core.fibertree import FTensor as TF
    pairs = [
        (RD.TensorDensity.calibrated(RF.from_dense("A", ["M", "K"], a)),
         TD.TensorDensity.calibrated(TF.from_dense("A", ["M", "K"], a))),
        (RD.TensorDensity.uniform("A", ["M", "K"], [64, 64], 0.1),
         TD.TensorDensity.uniform("A", ["M", "K"], [64, 64], 0.1)),
        (RD.TensorDensity.hypergeometric("A", ["M", "K"], [64, 64], 409.6),
         TD.TensorDensity.hypergeometric("A", ["M", "K"], [64, 64], 409.6)),
    ]
    for want, got in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    var_map = {"M": ("m",), "K": ("k",)}
    assert dataclasses.asdict(TD.mean_field_density(
        "Z", ["K", "M"], var_map, 300.0, {"m": 20.0, "k": 25.0},
        {"m": 30.0, "k": 40.0})) == dataclasses.asdict(RD.mean_field_density(
            "Z", ["K", "M"], var_map, 300.0, {"m": 20.0, "k": 25.0},
            {"m": 30.0, "k": 40.0}))
    shapes = {"p": 4.0, "r": 3.0}
    for terms, const, dom in (((("p", 1), ("r", 1)), 0, 6.0),
                              ((("p", 1), ("r", 1)), -1, 6.0),
                              ((), 9, 6.0), ((("p", 1), ("r", -1)), 0, 5.0)):
        assert TD.affine_hit_fraction(terms, const, shapes, dom) == \
            RD.affine_hit_fraction(terms, const, shapes, dom)
    for dom, balls in ((100, 0), (1, 50), (100, 1), (100, 500), (7.5, 3)):
        assert TD.expected_distinct(dom, balls) == \
            RD.expected_distinct(dom, balls)
