"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` (all
sources at once, one ``nvcc`` each), and the objects link into one
shared library with a plain C interface, loaded through ``ctypes``.
Builds are named by a digest of the sources and flags, so an edited
source never loads a stale build.  The build runs at first use, into
``build/presto_tpu_torch/`` at the repository root (git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "presto_tpu_torch"
KERNELS = ("expr_eval", "packed_group_agg", "packed_fold_finalize", "keys", "join_build",
           "join_probe", "join_expand", "sorted_group_agg", "topn", "window_eval",
           "spill_partition", "container_eval", "unnest_expand", "group_collect", "group_topn",
           "kmv_lanes", "raw_string_eval", "geo_contains", "ml_state", "ml_finalize",
           "exchange_partition", "merge_sorted")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
COMPILE_FLAGS = ARCH + ["-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]
LINK_FLAGS = ARCH + ["-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: ``-Xptxas -v`` output of each source this process compiled
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build "
                           "the presto_tpu_torch kernels)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest(*parts: bytes) -> str:
    return hashlib.sha1(b"\0".join(parts)).hexdigest()[:12]


def _object(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return BUILD_DIR / f"{name}-{_digest(src, headers, ' '.join(COMPILE_FLAGS).encode())}.o"


def _library_path() -> Path:
    objs = b"".join(_object(n).name.encode() for n in KERNELS)
    return BUILD_DIR / f"libpresto_tpu_torch-{_digest(objs, ' '.join(LINK_FLAGS).encode())}.so"


def _run_all(cmds: Dict[str, list]) -> Dict[str, str]:
    """Run the commands at once; their combined output by key."""
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, c in cmds.items()}
    logs = {}
    for k, p in procs.items():
        logs[k], _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{logs[k]}")
    return logs


def build_all() -> Path:
    """Compile the sources (in parallel) and link the library, unless
    this exact build exists; returns the library's path."""
    with _lock:
        lib = _library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f".{os.getpid()}.tmp"
        todo = {n: _object(n) for n in KERNELS if not _object(n).exists()}
        logs = _run_all({n: [_nvcc(), *COMPILE_FLAGS, "-I", str(CSRC), "-o",
                             str(o) + tag, str(CSRC / f"{n}.cu")]
                         for n, o in todo.items()})
        for n, o in todo.items():
            ptxas_report[n] = logs[n]
            os.replace(str(o) + tag, o)  # atomic: a concurrent build sees all or nothing
        _run_all({"link": [_nvcc(), *LINK_FLAGS, "-o", str(lib) + tag,
                           *[str(_object(n)) for n in KERNELS]]})
        os.replace(str(lib) + tag, lib)
        return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        path = build_all()
        with _lock:
            if _lib is None:
                _lib = ctypes.CDLL(str(path))
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptrs(values) -> "ctypes.Array":
    """A C array of int64 (device pointers or integers)."""
    values = list(values)
    return (ctypes.c_longlong * max(len(values), 1))(*values)


def ints(values) -> "ctypes.Array":
    """A C array of int32."""
    values = list(values)
    return (ctypes.c_int * max(len(values), 1))(*values)


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(tensors, what: str) -> None:
    """Every tensor lies on one CUDA device and is contiguous."""
    dev = None
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what}: tensor on {t.device}, expected CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous tensor")
