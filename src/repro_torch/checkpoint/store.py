"""Atomic, async-capable checkpointing (the reference's
``checkpoint/store.py``, without JAX).

Layout (one directory per step), the reference's to the byte:

    <dir>/step_000123/
        manifest.json       pytree structure + leaf shapes/dtypes + meta
        leaf_00000.npy ...  one file per leaf (streams well to blob stores)
    <dir>/step_000123.tmp/  staging dir, atomically renamed on success
    <dir>/LATEST            text file naming the newest complete step

Pytrees are nested dicts, lists and tuples (``None`` is an empty
subtree), flattened in JAX's leaf order -- dict keys sorted -- with
JAX's ``keystr`` path strings, so a store written by either package
loads in the other.  Leaves are numpy arrays, scalars or torch tensors
(moved to the host with ``.cpu().numpy()``); bfloat16 leaves are
widened to float32 on disk (exact) and come back as ``torch.bfloat16``.

Fault-tolerance properties:
  * atomic publish: a crash mid-write leaves only a .tmp dir, never a
    half-visible checkpoint; LATEST is written after the rename;
  * async save: ``save_async`` snapshots tensors to host then writes on
    a worker thread, so the caller resumes immediately;
  * restore onto a device: ``restore_resharded`` puts every leaf on the
    target device (the checkpoint stores the whole logical array);
  * retention: keep the newest ``keep`` checkpoints, delete older.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Params = Any


# ---------------------------------------------------------------------- #
# pytrees: nested dict / list / tuple, in JAX's leaf order
# ---------------------------------------------------------------------- #
def _is_node(x: Any) -> bool:
    return x is None or type(x) in (dict, list, tuple)


def _children(node: Any) -> List[Tuple[str, Any]]:
    """(keystr segment, child) of a container, in JAX's order."""
    if node is None:
        return []
    if type(node) is dict:
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    return [(f"[{i}]", c) for i, c in enumerate(node)]


def _flatten_with_paths(tree: Params) -> Tuple[List[Any], List[str], str]:
    """(leaves, keystr paths, treedef string) of ``tree``."""
    leaves: List[Any] = []
    paths: List[str] = []

    def walk(node: Any, path: str) -> str:
        if not _is_node(node):
            leaves.append(node)
            paths.append(path)
            return "*"
        if node is None:
            return "None"
        parts = [(seg, walk(c, path + seg)) for seg, c in _children(node)]
        if type(node) is dict:
            return "{" + ", ".join(f"{seg[1:-1]}: {s}"
                                   for seg, s in parts) + "}"
        inner = ", ".join(s for _, s in parts)
        if type(node) is tuple:
            return f"({inner},)" if len(parts) == 1 else f"({inner})"
        return f"[{inner}]"

    treedef = walk(tree, "")
    return leaves, paths, f"PyTreeDef({treedef})"


def _unflatten(like: Params, leaves: List[Any]) -> Params:
    """``leaves`` (in JAX's order) rebuilt into the structure of
    ``like``."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if not _is_node(node):
            return next(it)
        if node is None:
            return None
        if type(node) is dict:
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        out = [build(c) for c in node]
        return tuple(out) if type(node) is tuple else out

    return build(like)


def _num_leaves(tree: Params) -> int:
    return len(_flatten_with_paths(tree)[0])


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 widened to float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or "bfloat16" in str(arr.dtype):
        # numpy cannot round-trip ml_dtypes (bf16); widen to f32
        # (exact) and restore from the manifest dtype on load
        arr = arr.astype(np.float32)
    return arr


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _shape(leaf: Any) -> List[int]:
    if isinstance(leaf, torch.Tensor):
        return list(leaf.shape)
    return list(np.asarray(leaf).shape)


def save_checkpoint(directory: str | Path, step: int, tree: Params,
                    extra_meta: Optional[Dict[str, Any]] = None) -> Path:
    """Synchronous atomic save of the whole pytree."""
    directory = Path(directory)
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, paths, treedef = _flatten_with_paths(tree)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "paths": paths,
        "dtypes": [_dtype_name(x) for x in leaves],
        "shapes": [_shape(x) for x in leaves],
        "treedef": treedef,
        "meta": extra_meta or {},
        "time": time.time(),
    }
    for i, leaf in enumerate(leaves):
        np.save(tmp / f"leaf_{i:05d}.npy", _to_host(leaf))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    (directory / "LATEST").write_text(final.name)
    return final


def _step_dir(directory: Path, step: Optional[int]) -> Path:
    if step is None:
        return directory / (directory / "LATEST").read_text().strip()
    return directory / f"step_{step:09d}"


def load_manifest(directory: str | Path,
                  step: Optional[int] = None) -> Dict[str, Any]:
    """The manifest dict of a checkpoint (latest by default) without
    touching the leaves.  Lets a consumer that stored its structure in
    ``extra_meta`` (e.g. sweep checkpoints: point labels, error
    strings) rebuild a ``like`` pytree before calling
    :func:`load_checkpoint`."""
    path = _step_dir(Path(directory), step)
    return json.loads((path / "manifest.json").read_text())


def load_checkpoint(directory: str | Path, step: Optional[int] = None,
                    like: Optional[Params] = None) -> Tuple[Params, int]:
    """Load a checkpoint as host leaves, re-built into the structure of
    ``like`` (required -- the structure is not serialized executably,
    by design).  Leaves are numpy arrays, except bfloat16 ones, which
    numpy has no type for: those are CPU ``torch.bfloat16`` tensors."""
    path = _step_dir(Path(directory), step)
    manifest = json.loads((path / "manifest.json").read_text())
    leaves: List[Any] = []
    for i in range(manifest["n_leaves"]):
        arr = np.load(path / f"leaf_{i:05d}.npy")
        if "bfloat16" in manifest["dtypes"][i]:
            leaves.append(torch.from_numpy(arr).to(torch.bfloat16))
        else:
            leaves.append(arr)
    if like is None:
        raise ValueError("load_checkpoint: pass `like=` target pytree")
    want = _num_leaves(like)
    if want != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, target "
                         f"{want}")
    return _unflatten(like, leaves), manifest["step"]


def restore_resharded(directory: str | Path, like: Params, device=None,
                      step: Optional[int] = None) -> Tuple[Params, int]:
    """Restore every leaf as a torch tensor on ``device``, in the dtype
    of its ``like`` leaf where that has one.  The reference re-lays
    leaves out onto a new mesh; on the port's one device that is putting
    them on the target device: the CUDA device unless ``device`` names
    another (raises without a card, see ``resolve_device``)."""
    from repro_torch.kernels.backends import resolve_device
    dev = resolve_device(device)
    host_tree, got_step = load_checkpoint(directory, step, like=like)
    host, _, _ = _flatten_with_paths(host_tree)
    old, _, _ = _flatten_with_paths(like)
    out = []
    for new, ref in zip(host, old):
        t = new if isinstance(new, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(new))
        if isinstance(ref, torch.Tensor):
            t = t.to(ref.dtype)
        out.append(t.to(dev))
    return _unflatten(like, out), got_step


class CheckpointManager:
    """Async save + retention + resume."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: seconds each save took to write its checkpoint (an async
        #: save's on its worker thread, its snapshot to host apart)
        self.write_seconds: List[float] = []

    # ------------------------------------------------------------------ #
    def save_async(self, step: int, tree: Params,
                   extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host, then write on a background thread."""
        self.wait()                              # one in flight at a time
        leaves, _, _ = _flatten_with_paths(tree)
        snap = [x.detach().cpu().clone() if isinstance(x, torch.Tensor)
                else np.array(x, copy=True) for x in leaves]
        host_tree = _unflatten(tree, snap)

        def work():
            try:
                t0 = time.perf_counter()
                save_checkpoint(self.directory, step, host_tree,
                                extra_meta)
                self.write_seconds.append(time.perf_counter() - t0)
                self._gc()
            except BaseException as ex:          # surfaced on next wait()
                self._error = ex

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Params,
             extra_meta: Optional[Dict[str, Any]] = None) -> Path:
        self.wait()
        t0 = time.perf_counter()
        path = save_checkpoint(self.directory, step, tree, extra_meta)
        self.write_seconds.append(time.perf_counter() - t0)
        self._gc()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ #
    def latest_step(self) -> Optional[int]:
        latest = self.directory / "LATEST"
        if not latest.exists():
            return None
        name = latest.read_text().strip()
        if not (self.directory / name / "manifest.json").exists():
            return None
        return int(name.split("_")[1])

    def restore(self, like: Params, device=None,
                step: Optional[int] = None) -> Tuple[Params, int]:
        return restore_resharded(self.directory, like, device, step)

    def steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.directory.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp")
                      and (p / "manifest.json").exists())

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:09d}",
                          ignore_errors=True)
