"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``kernels/<name>/csrc/<lib>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/repro_torch/<lib>.so`` at the repository root (a
git-ignored directory), with a plain C interface: each exported function
takes raw pointers and the CUDA stream as ``void*`` and returns the
``cudaGetLastError`` code of its launch. Nothing here runs at import time.
There is one build route, ``build_all``: every source at once, one ``nvcc``
process each. ``library`` calls it on first use when the ``.so`` is missing
or older than its source, then loads the library.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Library name -> its ``.cu`` source, for every kernel in the package."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _stale(name: str) -> bool:
    """Whether ``name``'s library is missing or older than any CUDA source
    or header of the package (a source may include another kernel's
    header, as ``head_tokens.cu`` includes the sampler's device code)."""
    so = BUILD_DIR / f"{name}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in KERNELS_DIR.glob("*/csrc/*.cu*"))
    return so.stat().st_mtime < newest


def _start(name: str, src: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, BUILD_DIR / f"{name}.so")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(out)
    return out


def build_all() -> Dict[str, object]:
    """Compile every source, all ``nvcc`` processes at once. Returns
    ``{"seconds": wall time, "built": [names], "ptxas": {name: log}}``."""
    t0 = time.perf_counter()
    procs = {n: _start(n, s) for n, s in sources().items()}
    logs = {}
    errors: List[str] = []
    for n, p in procs.items():
        try:
            logs[n] = _finish(n, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "ptxas": logs}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name`` (built first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build_all()
        lib = ctypes.CDLL(str(BUILD_DIR / f"{name}.so"))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def bind(name: str, fn: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """Library ``name``'s ``fn(void* x n_ptrs, int x n_ints, float x
    n_floats, void* stream) -> int``, declared once and cached, so a launch
    makes one ctypes call."""
    f = getattr(library(name), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                  + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
