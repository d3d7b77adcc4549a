"""Build the hand-written CUDA kernels at first use and load them.

Each source in ``kernels/csrc/`` is compiled by its own ``nvcc`` process
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), and loaded with ``ctypes``.  The libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
their source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
Nothing here runs at import time, and nothing catches a failed build: it
raises ``KernelError`` with the compiler's output, as a failed launch
does (``check``), so that no caller that recovers from a ``RuntimeError``
(the trainer's crash recovery) can take either for a passing fault.  Builds and loads hold one module
lock, so threads that reach an unbuilt kernel at once (a sweep's thread
executor) build it once.

No library links against the driver (``-lcuda``): ``flash_attention.cu``
encodes its TMA tensor maps with ``cuTensorMapEncodeTiled``, which it
reaches through the runtime's ``cudaGetDriverEntryPoint``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

#: the kernel libraries: one per source file in csrc/
SOURCES = ("search", "merge_path", "multi_merge", "ssd_chunk",
           "flash_attention", "flash_attention_bwd", "block_sparse_matmul",
           "ssd_chunk_bwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")



class KernelError(RuntimeError):
    """A kernel that did not build or a launch that returned a CUDA
    error: never retried."""


_LIBS: Dict[str, ctypes.CDLL] = {}
#: held by ``build`` and ``_load``: one thread compiles or loads at a time
_LOCK = threading.RLock()
#: nvcc's output (``-Xptxas -v`` register / shared-memory lines) of each
#: library built by this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the CUDA kernels of repro_torch are "
                      "built at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    """The library of ``csrc/{name}.cu``, named by a hash of the source,
    every header in ``csrc/`` (a source may include any of them) and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named library that is not built yet, all ``nvcc``
    processes at once; returns name -> library path."""
    names = tuple(SOURCES if names is None else names)
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> Dict[str, Path]:
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOGS[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise KernelError("CUDA kernel build failed:\n"
                              + "\n".join(failed))
    return targets


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build([name])[name]))
                lib.repro_error_string.argtypes = [ctypes.c_int]
                lib.repro_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of library ``name`` (built first when
    needed), typed: pointers and the stream as ``c_void_p``, so ctypes
    never truncates them to 32 bits; returns the launch's CUDA error."""
    fn = getattr(_load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise when a launch of library ``name`` returned a CUDA error."""
    if code != 0:
        msg = _load(name).repro_error_string(code).decode()
        raise KernelError(f"{name} kernel launch failed: CUDA error "
                          f"{code} ({msg})")
