"""Build the CUDA kernels with nvcc and load them through ctypes.

The sources are ``csrc/*.cu`` (plain C interface, no PyTorch headers, so a
build takes seconds).  Each source compiles in an nvcc process of its own,
all started together, and one more links the objects into a shared
library in ``_build/`` inside the package, named by a hash of the
sources, at first use.  A failed build raises with nvcc's stderr.

Every kernel wrapper counts its launches in ``LAUNCHES`` (one per kernel
launch, keyed by kernel name), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# name -> argtypes of the extern "C" entry point (each returns cudaError_t)
_SIGNATURES = {
    # syms, state0, out, err, C, K, debug, stream
    "mtf_shuffle": [_P, _P, _P, _P, _I64, _I32, _I32, _P],
    # off, width, zp1, val, out_len, out, B, M, stream
    "rle2_expand": [_P, _P, _P, _P, _P, _P, _I32, _I64, _P],
    # w, hi2, used, words, B, E, nwords, stream
    "pack_words": [_P, _P, _P, _P, _I32, _I64, _I64, _P],
    # mask, payload, base, out, n_tiles, tile, stream
    "compact_stream": [_P, _P, _P, _P, _I64, _I32, _P],
}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; wait for all, then raise with the
    stderr of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate()[1] for p in procs]
    for cmd, p, err in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}"
            )


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet) and
    return the shared library's path."""
    srcs = sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"libbanzai_kernels-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    work = BUILD_DIR / f"{so.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in srcs if p.suffix == ".cu"]
    objs = [work / f"{p.stem}.o" for p in cus]
    try:
        _run_all([
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-c", "-o", str(o), str(p)]
            for p, o in zip(cus, objs)
        ])
        tmp = work / so.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once, whichever
    thread asks first)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def launch(name: str, *args) -> None:
    """Call kernel entry point ``name`` on the current CUDA stream; raise
    if the launch was refused.  Tensors are passed as device pointers."""
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, name)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    LAUNCHES[name] += 1
