"""Carry tensors from the reference package into this one.

The reference package's ``CSF`` and ``FTensor`` objects are read
through their public fields only (numpy arrays, rank names, shapes,
leaf iteration), never by importing the reference, and rebuilt as this
package's objects.  A test feeds one set of reference inputs through
both simulators this way, so that they simulate exactly the same data.
Model parameters arrive as the reference's pytree of numpy arrays and
become this package's modules (``model_params_from_reference``); an
optimizer state over them becomes this package's state over the module's
parameter names (``optimizer_state_from_reference``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.csf import CSF
from .core.fibertree import Fiber, FTensor


def csf_from_arrays(name: str, ranks: Sequence[str],
                    coords: Sequence[np.ndarray],
                    segments: Sequence[Optional[np.ndarray]],
                    values: np.ndarray,
                    rank_shapes: Optional[Dict[str, Any]] = None,
                    default: Any = 0,
                    upper_ranks: Optional[set] = None) -> CSF:
    """This package's ``CSF`` from the fields of a reference ``CSF``
    (copied, so the two never share a buffer)."""
    return CSF(name, list(ranks), [np.array(c) for c in coords],
               [None if s is None else np.array(s) for s in segments],
               np.array(values), dict(rank_shapes or {}), default,
               set(upper_ranks or ()))


def ftensor_from_dense(name: str, ranks: Sequence[str], array: Any,
                       default: Any = 0) -> FTensor:
    """This package's ``FTensor`` from a dense array whose axes follow
    ``ranks`` (the same tree the reference builds from it)."""
    return FTensor.from_dense(name, list(ranks), np.asarray(array), default)


def ftensor_from_leaves(name: str, ranks: Sequence[str],
                        leaves: Iterable[Tuple[Tuple[Any, ...], Any]],
                        rank_shapes: Optional[Dict[str, Any]] = None,
                        default: Any = 0,
                        upper_ranks: Optional[set] = None) -> FTensor:
    """This package's ``FTensor`` from (path, value) leaves in the
    depth-first order ``FTensor.iter_leaves`` yields them.  Fibers with
    no leaf below them have no path and are not rebuilt."""
    out = FTensor(name, list(ranks), rank_shapes=dict(rank_shapes or {}),
                  default=default, upper_ranks=set(upper_ranks or ()))
    for path, val in leaves:
        node = out.root
        for c in path[:-1]:
            node = node.get_or_create(c, Fiber)
        node.insert(path[-1], val)
    return out


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def tensor_from_array(arr: Any) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit.  bfloat16 arrives as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: it is
    viewed as 16-bit integers and those as ``torch.bfloat16``."""
    arr = np.array(arr)                       # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr)


def _layer_stacks(cfg) -> Dict[str, int]:
    """The reference tree's per-layer stacks of ``cfg``'s family and how
    many layers each holds."""
    if cfg.family == "encdec":
        return {"enc": cfg.enc_layers, "dec": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"blocks": cfg.n_layers // cfg.hybrid_block}
    return {"blocks": cfg.n_layers}


def model_params_from_reference(tree: Dict[str, Any], cfg,
                                device=None) -> torch.nn.Module:
    """The reference's model parameter pytree, given as numpy arrays, as
    this package's model of ``cfg``'s family (``TransformerLM``,
    ``MoELM``, ``Mamba2LM``, ``HybridLM``, ``EncDecLM``) on ``device``
    (the CPU by default).

    Each per-layer stack (``blocks``; ``enc`` and ``dec`` for encdec; a
    hybrid's ``blocks`` hold superblocks) is a list of per-layer trees
    (``scan_layers=False``) or one tree of arrays stacked over the
    layers (``scan_layers=True``, built by ``jax.vmap``).  Empty
    subtrees (OLMo's non-parametric norms) and a missing ``head`` (tied
    embeddings) are absent on both sides.  Every parameter must be
    present with the port's shape and dtype; values are copied bit for
    bit."""
    from .models import api

    src = _reference_flat(tree, cfg)
    model = api.init(cfg, None, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name not in src:
                raise KeyError(f"reference tree has no {name}")
            t = tensor_from_array(src.pop(name))
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: reference {t.dtype} "
                                 f"{tuple(t.shape)}, port {p.dtype} "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
    if src:
        raise KeyError(f"reference parameters the port lacks: "
                       f"{sorted(src)}")
    return model


def optimizer_state_from_reference(tree: Dict[str, Any], cfg,
                                   device=None) -> Dict[str, Any]:
    """The reference optimizer's state over ``cfg``'s model parameters,
    given as numpy arrays -- AdamW's ``{"step", "m", "v", "master"}`` or
    Adafactor's ``{"step", "v"}`` (a ``{"vr", "vc"}`` or ``{"v"}`` dict a
    parameter) -- as this package's state (``optim.optimizers``) over the
    port module's parameter names, on ``device`` (the CPU by default).
    Each per-parameter tree is read as ``model_params_from_reference``
    reads the parameters; every leaf must be present, values bit for
    bit."""
    from .models import api

    names = [n for n, _ in api.init(cfg, None, "meta").named_parameters()]
    out: Dict[str, Any] = {
        "step": tensor_from_array(np.asarray(tree["step"])).to(device)}
    for key, sub in tree.items():
        if key == "step":
            continue
        flat = _reference_flat(sub, cfg)
        per: Dict[str, Any] = {}
        for n in names:
            if n in flat:
                per[n] = tensor_from_array(flat.pop(n)).to(device)
                continue
            parts = {part: tensor_from_array(flat.pop(f"{n}.{part}"))
                     .to(device) for part in ("v", "vc", "vr")
                     if f"{n}.{part}" in flat}
            if not parts:
                raise KeyError(f"reference state {key!r} has no {n}")
            per[n] = parts
        if flat:
            raise KeyError(f"reference state {key!r} entries the port "
                           f"lacks: {sorted(flat)}")
        out[key] = per
    return out


def _reference_flat(tree: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The reference's parameter pytree (or a tree over its parameters)
    flattened to the port's dotted parameter names, each per-layer stack
    unstacked into its layers."""
    src: Dict[str, Any] = {}
    stacks = _layer_stacks(cfg)
    for key, sub in tree.items():
        if key not in stacks:
            src.update(_flatten({key: sub}))
            continue
        if isinstance(sub, dict):
            stacked = _flatten(sub)
            n = len(next(iter(stacked.values()))) if stacked else 0
            sub = [{k: v[i] for k, v in stacked.items()} for i in range(n)]
        else:
            sub = [_flatten(b) for b in sub]
        if len(sub) != stacks[key]:
            raise ValueError(f"{len(sub)} {key} for {stacks[key]} layers")
        for i, blk in enumerate(sub):
            src.update({f"{key}.{i}.{k}": v for k, v in blk.items()})
    return src


def carry(obj: Any) -> Any:
    """A simulator input of the reference package as one of this
    package: a ``CSF`` (anything with ``segments``) or an ``FTensor``
    (anything with ``iter_leaves``) is rebuilt; a dense array is copied
    to a numpy array."""
    if hasattr(obj, "segments"):
        return csf_from_arrays(obj.name, obj.ranks, obj.coords,
                               obj.segments, obj.values, obj.rank_shapes,
                               obj.default, obj.upper_ranks)
    if hasattr(obj, "iter_leaves"):
        return ftensor_from_leaves(obj.name, obj.ranks, obj.iter_leaves(),
                                   obj.rank_shapes, obj.default,
                                   obj.upper_ranks)
    return np.array(obj)
