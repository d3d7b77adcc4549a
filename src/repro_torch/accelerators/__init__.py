"""The paper's accelerator designs as TeAAL specifications (port).

Each module exposes ``spec(**params) -> AcceleratorSpec`` mirroring the
published design (Figures 3, 8, 12; hardware parameters from Table 5),
plus the Table 2 cascade zoo in ``zoo``.  ``simulate`` runs one on real
tensors; its seams run on the CUDA device unless the caller names
another (``device='cpu'``: the kernels' plain versions).
"""
from typing import Any, Dict, Optional

from . import extensor, gamma, matraptor, outerspace, sigma, zoo

REGISTRY = {
    "outerspace": outerspace.spec,
    "extensor": extensor.spec,
    "gamma": gamma.spec,
    "sigma": sigma.spec,
    "matraptor": matraptor.spec,
}

#: per-design partition-size defaults needed to resolve symbolic mappings
DEFAULT_PARAMS: Dict[str, Optional[Dict[str, int]]] = {
    "extensor": extensor.DEFAULT_PARAMS,
}


def simulate(design: "str | Any", inputs: Dict[str, Any],
             var_shapes: Dict[str, int],
             params: Optional[Dict[str, int]] = None,
             backend: "str | Any" = "vector", device=None,
             model: bool = True, semiring=None, extra_instr=None,
             **spec_kw):
    """One-call entry point: run a design (REGISTRY name or an
    AcceleratorSpec) on real tensors; returns the SimResult.

    ``backend`` is 'vector' (columnar CSF co-iteration), 'python' (the
    interpreter oracle) or an ExecutorBackend instance.  ``device``
    selects where a 'vector' backend runs its seams: None means the
    CUDA device, and raises when there is none; 'cpu' runs the plain
    versions.  A backend instance brings its own device.
    ``extra_instr`` receives every instrumentation event beside the
    performance model (e.g. a ``CollectingInstr``)."""
    from repro_torch.core.generator import CascadeSimulator
    from repro_torch.core.vectorized import VectorBackend

    if isinstance(design, str):
        spec = REGISTRY[design](**spec_kw)
        if params is None:
            params = DEFAULT_PARAMS.get(design)
    else:
        if spec_kw:
            raise TypeError(
                "spec factory kwargs "
                f"{sorted(spec_kw)} require a registry name, not an "
                "already-built AcceleratorSpec")
        spec = design
    if backend == "vector":
        backend = VectorBackend(device=device)
    sim = CascadeSimulator(spec, params=params, semiring=semiring,
                           extra_instr=extra_instr, model=model,
                           backend=backend)
    return sim.run(dict(inputs), var_shapes)


__all__ = ["REGISTRY", "DEFAULT_PARAMS", "simulate", "extensor", "gamma",
           "matraptor", "outerspace", "sigma", "zoo"]
