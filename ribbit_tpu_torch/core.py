"""Python wrapper for the native event-driven core (csrc/ribbit_core.c).

A CoreSession owns a RibbitCore handle for one sequence: it runs the three
scan phases + merge lattices in C and then serves the overlay range queries
(popcount / longest-run) that seed refinement needs.  Events are either
generated natively from the 2-bit code (host path) or injected from the
CUDA event kernels (see scan_events.py).

The port's copy of ribbit_tpu/core.py, which it may not import.  The
library comes from the port's native._compile, which raises when the C
core does not build; get_core_lib never returns None.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .config import RibbitConfig
from .native import _compile, _CSRC


_lib = None
_tried = False
_lock = __import__("threading").Lock()


def get_core_lib():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        return _get_core_lib_locked()


def _get_core_lib_locked():
    global _lib, _tried
    if _tried:
        return _lib
    so = _compile([_CSRC / "ribbit_core.c", _CSRC / "ribbit_refine.c",
                   _CSRC / "ribbit_align.c", _CSRC / "ribbit_vote.c",
                   _CSRC / "ribbit_events.c"])
    lib = ctypes.CDLL(str(so))
    P8 = ctypes.POINTER(ctypes.c_int8)
    PU8 = ctypes.POINTER(ctypes.c_uint8)
    P64 = ctypes.POINTER(ctypes.c_int64)
    lib.ribbit_core_create.restype = ctypes.c_void_p
    lib.ribbit_core_create.argtypes = [P8, PU8, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32]
    lib.ribbit_core_set_events.restype = None
    lib.ribbit_core_set_events.argtypes = [ctypes.c_void_p] + [P64] * 9
    lib.ribbit_core_scan.restype = ctypes.c_int64
    lib.ribbit_core_scan.argtypes = [ctypes.c_void_p]
    lib.ribbit_core_get_seeds.restype = None
    lib.ribbit_core_get_seeds.argtypes = [ctypes.c_void_p, P64]
    lib.ribbit_core_overlay_bitcount.restype = ctypes.c_int64
    lib.ribbit_core_overlay_bitcount.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
    lib.ribbit_core_overlay_longest_run.restype = ctypes.c_int64
    lib.ribbit_core_overlay_longest_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
    lib.ribbit_core_drop_overlay.restype = None
    lib.ribbit_core_drop_overlay.argtypes = [ctypes.c_void_p]
    lib.ribbit_core_destroy.restype = None
    lib.ribbit_core_destroy.argtypes = [ctypes.c_void_p]
    lib.ribbit_refine_run.restype = ctypes.POINTER(ctypes.c_char)
    lib.ribbit_refine_run.argtypes = [
        ctypes.c_void_p, P8, PU8, P8, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        P64, P64, ctypes.c_int64, ctypes.c_char_p,
        P64, ctypes.c_int64, ctypes.c_int32, P64]
    lib.ribbit_core_set_threads.restype = None
    lib.ribbit_core_set_threads.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ribbit_core_anch_votes.restype = ctypes.c_int64
    lib.ribbit_core_anch_votes.argtypes = [ctypes.c_void_p]
    lib.ribbit_core_capture_runs.restype = None
    lib.ribbit_core_capture_runs.argtypes = [ctypes.c_void_p]
    lib.ribbit_core_runs_total.restype = ctypes.c_int64
    lib.ribbit_core_runs_total.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ribbit_core_runs_export.restype = None
    lib.ribbit_core_runs_export.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                            P64, P64, P64]
    lib.ribbit_scan_refine.restype = ctypes.POINTER(ctypes.c_char)
    lib.ribbit_scan_refine.argtypes = [
        ctypes.c_void_p, P8, PU8, P8, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        P64, P64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_int32, P64, P64]
    lib.ribbit_buffer_free.restype = None
    lib.ribbit_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    _lib = lib
    _tried = True
    return _lib


# the core stores event/emission positions as i32 (an order of magnitude
# above the longest real chromosome); contigs at or past this length are
# auto-chunked by the pipeline (process_sequence routes them through
# process_sequence_chunked) instead of reaching a CoreSession
MAX_CONTIG = 2**31 - 64


class CoreSession:
    """Owns a native core handle for one sequence (keeps the numpy buffers
    alive for the C side)."""

    def __init__(self, code: np.ndarray, n_mask: np.ndarray,
                 cfg: RibbitConfig, nthreads: int = 0):
        self.lib = get_core_lib()
        if code.shape[0] >= MAX_CONTIG:
            raise RuntimeError("native core: contig exceeds 2^31-64 bp")
        self.code = np.ascontiguousarray(code, dtype=np.int8)
        self.n_mask = np.ascontiguousarray(n_mask).view(np.uint8)
        self.cfg = cfg
        self.nthreads = nthreads
        self.handle = self.lib.ribbit_core_create(
            self.code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            self.n_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            code.shape[0], cfg.min_motif, cfg.max_motif)
        if nthreads:
            self.lib.ribbit_core_set_threads(self.handle, nthreads)

    def set_events(self, perf, q7, q6) -> None:
        """Inject device-produced events.  Each of perf/q7/q6 is a tuple of
        (starts int64[N], ends int64[N], offsets int64[nmotifs+1])."""
        def p(a):
            a = np.ascontiguousarray(a, dtype=np.int64)
            return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        keep = []
        ptrs = []
        for group in (perf, q7, q6):
            for arr in group:
                a, ptr = p(arr)
                keep.append(a)
                ptrs.append(ptr)
        self._events_keepalive = keep
        self.lib.ribbit_core_set_events(self.handle, *ptrs)

    def capture_runs(self):
        """Generate events in capture mode: the threaded C generation pass
        records raw qualified runs + perfect runs per channel instead of
        feeding the scanner state machines.  Returns (perfect, q7, q6)
        streams in the set_events contract ((starts, ends,
        offsets[nmotifs+1]) each, channel-major).  The session is spent
        after this call (use a fresh one for scan/refine)."""
        P64 = ctypes.POINTER(ctypes.c_int64)
        self.lib.ribbit_core_capture_runs(self.handle)
        out = []
        for stream in range(3):
            n = self.lib.ribbit_core_runs_total(self.handle, stream)
            s = np.empty(n, dtype=np.int64)
            e = np.empty(n, dtype=np.int64)
            off = np.empty(self.cfg.nmotifs + 1, dtype=np.int64)
            self.lib.ribbit_core_runs_export(
                self.handle, stream, s.ctypes.data_as(P64),
                e.ctypes.data_as(P64), off.ctypes.data_as(P64))
            out.append((s, e, off))
        return tuple(out)

    def scan(self) -> np.ndarray:
        """Runs scan+lattices+merge; returns int64[N, 4] seed array
        (start, end, mlen, rank) in emission order."""
        n = self.lib.ribbit_core_scan(self.handle)
        out = np.empty((n, 4), dtype=np.int64)
        if n:
            self.lib.ribbit_core_get_seeds(
                self.handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def anch_votes(self) -> int:
        """Executions of the anchored coverage-vote blocks so far (the
        positional j-indexed quirk, parse_anchored_shiftxor.cpp:441-526) —
        the only lattice reads that reach back to the list heads.  A
        chunk-split replay is exact iff no chunk after the first voted."""
        return int(self.lib.ribbit_core_anch_votes(self.handle))

    def refine(self, seeds: np.ndarray, sequence: str,
               sequence_id: str) -> list[str]:
        """Native refinement of the merged seed stream -> BED lines."""
        from .align import _TRANSLATE
        raw = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
        translated = np.ascontiguousarray(_TRANSLATE[raw & 0x7F])
        cfg = self.cfg
        tbl, min_len, perf_units = self._refine_tables()
        seeds = np.ascontiguousarray(seeds, dtype=np.int64)
        out_len = ctypes.c_int64(0)
        P64 = ctypes.POINTER(ctypes.c_int64)
        buf = self.lib.ribbit_refine_run(
            self.handle,
            self.code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            self.n_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            translated.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            self.code.shape[0], cfg.min_motif, cfg.max_motif, cfg.min_shift,
            min_len.ctypes.data_as(P64), perf_units.ctypes.data_as(P64),
            tbl, sequence_id.encode("latin-1", errors="replace"),
            seeds.ctypes.data_as(P64), seeds.shape[0], self.nthreads,
            ctypes.byref(out_len))
        text = ctypes.string_at(buf, out_len.value).decode("latin-1")
        self.lib.ribbit_buffer_free(buf)
        return text.splitlines()

    def _refine_tables(self):
        cfg = self.cfg
        tbl = cfg.max_motif + 1
        min_len = np.zeros(tbl, dtype=np.int64)
        perf_units = np.zeros(tbl, dtype=np.int64)
        for m, v in cfg.minimum_length.items():
            if 0 <= m < tbl:
                min_len[m] = v
        for m, v in cfg.perfect_units.items():
            if 0 <= m < tbl:
                perf_units[m] = v
        return tbl, min_len, perf_units

    def scan_refine(self, sequence: str, sequence_id: str,
                    drop_overlay: bool = False) -> list[str]:
        """Combined scan + refinement with the serial anchored consume
        overlapped by the refinement pool (ribbit_scan_refine).  Output is
        byte-identical to scan() followed by refine().  drop_overlay frees
        the packed overlay cache between the scan and the refine tail
        (large contigs), exactly like the two-phase path's drop."""
        from .align import _TRANSLATE
        raw = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
        translated = np.ascontiguousarray(_TRANSLATE[raw & 0x7F])
        cfg = self.cfg
        tbl, min_len, perf_units = self._refine_tables()
        out_len = ctypes.c_int64(0)
        nseeds = ctypes.c_int64(0)
        P64 = ctypes.POINTER(ctypes.c_int64)
        buf = self.lib.ribbit_scan_refine(
            self.handle,
            self.code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            self.n_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            translated.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            self.code.shape[0], cfg.min_motif, cfg.max_motif, cfg.min_shift,
            min_len.ctypes.data_as(P64), perf_units.ctypes.data_as(P64),
            tbl, sequence_id.encode("latin-1", errors="replace"),
            self.nthreads, 1 if drop_overlay else 0,
            ctypes.byref(out_len), ctypes.byref(nseeds))
        text = ctypes.string_at(buf, out_len.value).decode("latin-1")
        self.lib.ribbit_buffer_free(buf)
        return text.splitlines()

    def overlay_bitcount(self, midx: int, a: int, b: int) -> int:
        return self.lib.ribbit_core_overlay_bitcount(self.handle, midx, a, b)

    def overlay_longest_run(self, midx: int, a: int, b: int) -> int:
        return self.lib.ribbit_core_overlay_longest_run(self.handle, midx, a, b)

    def drop_overlay(self) -> None:
        """Free the packed overlay cache (~12.4 B/bp); refinement's
        has-run-of-3 gate falls back to chunked early-exit recompute."""
        self.lib.ribbit_core_drop_overlay(self.handle)

    def close(self) -> None:
        if self.handle:
            self.lib.ribbit_core_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
