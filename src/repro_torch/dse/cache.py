"""Result cache: serve repeated what-if queries without the backend.

A design-space query is a pure function of (workload, design point,
backend, fidelity mode): the analytic model has no hidden state, so two
evaluations of the same point on the same workload return bit-identical
objectives.  The cache exploits that purity at two scopes:

  * **in-memory LRU** -- bounded ``capacity`` of most recently used
    results, shared by every consumer of one :class:`ResultCache`
    (the sweep engine, the sweep service, search optimizers);
  * **persistent store** (optional ``directory``) -- ok-results are
    flushed through :mod:`repro_torch.checkpoint.store`'s atomic publish,
    so a later process resumes with the whole cache warm.

The key is content-addressed, NOT object-addressed: a sha256 digest of
(workload hash, mapping signature, design id, spec kwargs, params,
backend, fidelity mode).  Consequences:

  * two ``DesignPoint`` objects describing the same configuration hit
    the same entry, whatever process built them (no dependence on
    ``PYTHONHASHSEED`` or object identity);
  * the *workload hash* covers the input tensor contents and the var
    shapes -- change the operands and the cache is cold, so stale
    results cannot leak across workloads (invalidation by keying);
  * failed / timed-out results are never cached: transient faults must
    not be replayed as facts.

Hits and misses are tallied on ``dse.result_cache/{hit,miss}``
counters (:mod:`repro_torch.obs.metrics`).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

#: objective fields a cache entry carries (alphabetical, matching the
#: sweep-checkpoint convention so persisted trees stay deterministic)
_CACHE_FIELDS = ("dram_bytes", "energy_pj", "seconds")


def workload_hash(inputs: Dict[str, Any],
                  var_shapes: Dict[str, int]) -> str:
    """Content hash of a workload: input tensor values + var shapes.

    Dense arrays hash their raw bytes; fibertree tensors densify first
    (exact -- the dense image determines the tree).  Anything else
    falls back to ``repr``, which is conservative: an unstable repr
    only costs cache misses, never wrong hits.  The digest equals the
    reference package's for the same inputs.
    """
    h = hashlib.sha256()
    for name in sorted(inputs):
        val = inputs[name]
        h.update(name.encode())
        dense = None
        if isinstance(val, np.ndarray):
            dense = val
        elif hasattr(val, "to_dense"):
            try:
                dense = val.to_dense()
            except Exception:           # noqa: BLE001 - repr fallback
                dense = None
        if dense is not None:
            arr = np.ascontiguousarray(dense)
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
        else:
            h.update(repr(val).encode())
    h.update(repr(sorted(var_shapes.items())).encode())
    return h.hexdigest()[:16]


def result_key(workload: str, signature: str, point,
               backend: str, mode: str) -> str:
    """Content-addressed cache key for one (workload, point) query."""
    design = point.design if isinstance(point.design, str) else \
        getattr(point.design, "__qualname__", repr(point.design))
    blob = "\x1f".join((
        workload,
        signature,
        design,
        repr(tuple(point.spec_kw)),
        repr(tuple(point.params)),
        backend,
        mode,
    ))
    return hashlib.sha256(blob.encode()).hexdigest()


class ResultCache:
    """Bounded LRU of evaluated objectives, optionally persistent.

    Entries map a :func:`result_key` digest to the objective tuple
    ``(seconds, energy_pj, dram_bytes)``.  ``get`` / ``put`` are
    thread-safe under CPython's GIL for the OrderedDict operations
    used; the sweep service serializes access anyway.
    """

    def __init__(self, capacity: int = 4096,
                 directory: "str | Path | None" = None,
                 keep: int = 3):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.directory = Path(directory) if directory is not None else None
        self.keep = keep
        self._data: "OrderedDict[str, Tuple[float, float, float]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self._dirty = 0
        if self.directory is not None:
            self._load()

    def __len__(self) -> int:
        return len(self._data)

    # ------------------------------------------------------------------ #
    def get(self, key: str) -> Optional[Dict[str, float]]:
        """The cached objectives for ``key`` or None; counts the
        outcome on ``dse.result_cache/{hit,miss}``."""
        from repro_torch.obs.metrics import metrics
        entry = self._data.get(key)
        if entry is None:
            self.misses += 1
            metrics().counter("dse.result_cache/miss").inc()
            return None
        self._data.move_to_end(key)
        self.hits += 1
        metrics().counter("dse.result_cache/hit").inc()
        seconds, energy_pj, dram_bytes = entry
        return {"seconds": seconds, "energy_pj": energy_pj,
                "dram_bytes": dram_bytes}

    def put(self, key: str, seconds: float, energy_pj: float,
            dram_bytes: float) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = (float(seconds), float(energy_pj),
                           float(dram_bytes))
        self._dirty += 1
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._data)}

    # ------------------------------------------------------------------ #
    # persistence (atomic, via repro_torch.checkpoint.store)
    # ------------------------------------------------------------------ #
    def flush(self) -> bool:
        """Publish the current entries atomically to ``directory``.
        No-op (returns False) without a directory or new entries."""
        if self.directory is None or self._dirty == 0:
            return False
        from repro_torch.checkpoint.store import CheckpointManager
        keys = list(self._data)                     # LRU -> MRU order
        tree = {f: np.array([self._data[k][i] for k in keys],
                            dtype=np.float64)
                for i, f in enumerate(_CACHE_FIELDS)}
        meta = {"kind": "dse-result-cache", "keys": keys}
        mgr = CheckpointManager(self.directory, keep=self.keep)
        # step = entry count; equal counts overwrite atomically
        mgr.save(len(keys), tree, extra_meta=meta)
        self._dirty = 0
        return True

    def _load(self) -> None:
        if not (self.directory / "LATEST").exists():
            return
        from repro_torch.checkpoint.store import load_checkpoint, load_manifest
        manifest = load_manifest(self.directory)
        meta = manifest.get("meta", {})
        if meta.get("kind") != "dse-result-cache":
            raise ValueError(
                f"checkpoint at {self.directory} is not a result cache "
                f"(kind={meta.get('kind')!r})")
        keys: Sequence[str] = meta["keys"]
        like = {f: np.zeros(len(keys)) for f in _CACHE_FIELDS}
        tree, _ = load_checkpoint(self.directory, like=like)
        for i, k in enumerate(keys):                # preserves LRU order
            self._data[k] = tuple(
                float(tree[f][i]) for f in _CACHE_FIELDS)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
        self._dirty = 0
