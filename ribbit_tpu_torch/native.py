"""ctypes bindings for the repository's C core (csrc/ at the repo root).

Counterpart of ribbit_tpu/native.py.  The port compiles the same C sources
(it does not copy them) into its own build/native/, keyed by a hash of the
sources, and differs in three ways: a build that fails raises with the
compiler's output (the JAX package then moves to its Python engine
unasked; here nothing returns None); the library is written under a
temporary name and moved into place with os.replace, so processes
building at once never load a half-written file; and RIBBIT_NO_NATIVE is
not read.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

_REPO = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _REPO / "csrc"
_PORT_CSRC = _REPO / "ribbit_tpu_torch" / "csrc"
_BUILD = _REPO / "build" / "native"


def _compile(srcs, includes=()) -> pathlib.Path:
    """Compile the sources into one cached .so and return its path; raises
    RuntimeError with every compiler's output if none builds it.  The cache
    key hashes the sources and the files they #include (`includes`)."""
    srcs = list(srcs)
    h = hashlib.sha256(b"".join(
        s.read_bytes() for s in srcs + list(includes))).hexdigest()[:16]
    out = _BUILD / f"{srcs[0].stem}_{h}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    errors = []
    for cc in ("cc", "gcc", "clang"):
        cmd = ([cc, "-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
               + [str(s) for s in srcs] + ["-o", str(tmp), "-lm"])
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            errors.append(f"{cc}: {exc}")
            continue
        if r.returncode == 0 and tmp.exists():
            os.replace(tmp, out)       # atomic: concurrent builds agree
            return out
        errors.append(f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"{', '.join(s.name for s in srcs)} did not build:\n"
                       + "\n".join(errors))


@functools.cache
def get_align_lib():
    """The C core with its aligner entry (ribbit_align) bound."""
    from .core import get_core_lib
    base = get_core_lib()
    base.ribbit_align.restype = ctypes.c_int
    base.ribbit_align.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32,
    ]
    return base


@functools.cache
def get_events_lib():
    """The C core with its flagword decoder entry bound."""
    from .core import get_core_lib
    base = get_core_lib()
    P32 = ctypes.POINTER(ctypes.c_int32)
    P64 = ctypes.POINTER(ctypes.c_int64)
    base.ribbit_decode_bitmaps.restype = ctypes.c_int64
    base.ribbit_decode_bitmaps.argtypes = [
        P32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, P64,
        ctypes.c_int64, P32, P32, P32, P32, P32, P32, P64,
    ]
    return base


@functools.cache
def get_vote_lib():
    """The C core with its diagonal-voting entries bound."""
    from .core import get_core_lib
    base = get_core_lib()
    base.ribbit_vote_longer.restype = ctypes.c_int32
    base.ribbit_vote_longer.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    base.ribbit_vote_prefix_batch.restype = None
    base.ribbit_vote_prefix_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return base


@functools.cache
def get_traceback_lib():
    """ribbit_tpu_torch/csrc/traceback.c, which #includes the C core's
    aligner (csrc/ribbit_align.c), as a library of its own with its batch
    traceback entry bound; raises if it does not build."""
    so = _compile([_PORT_CSRC / "traceback.c"],
                  includes=[_CSRC / "ribbit_align.c"])
    lib = ctypes.CDLL(str(so))
    P8 = ctypes.POINTER(ctypes.c_int8)
    P32 = ctypes.POINTER(ctypes.c_int32)
    P64 = ctypes.POINTER(ctypes.c_int64)
    lib.ribbit_traceback_batch.restype = ctypes.c_int
    lib.ribbit_traceback_batch.argtypes = [
        ctypes.c_int32, P8, P64, P64, P8, P64, P64, P32, P32, P32, P32, P32,
        ctypes.c_char_p, P64, P32, P32, ctypes.c_int32,
    ]
    return lib
