"""Builds the port's CUDA sources (ribbit_tpu_torch/csrc/*.cu) with nvcc at
first use and loads them with ctypes.

Each source compiles on its own into build/cuda/<stem>_<sha16>.so, keyed by
a hash of the source (the same scheme as ribbit_tpu/native.py uses for the
C core), so an edited kernel rebuilds and an unchanged one loads from the
cache.  The entry points have a plain C interface: no PyTorch headers, so a
build takes seconds.  A failed build raises with nvcc's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build" / "cuda"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda, in that order."""
    home = os.environ.get("CUDA_HOME")
    cands = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(pathlib.Path(which))
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def build(stem: str) -> pathlib.Path:
    """Compile csrc/<stem>.cu into the hash-keyed shared object and return
    its path; raises RuntimeError with nvcc's output if the build fails."""
    src = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD / f"{stem}_{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or not tmp.exists():
        raise RuntimeError(f"nvcc failed ({r.returncode}) building {src}:\n"
                           f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)           # atomic: concurrent builds agree
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = _loaded[stem] = ctypes.CDLL(str(build(stem)))
        return lib
