"""Python wrapper for the native event-driven core (csrc/ribbit_core.c).

A CoreSession owns a RibbitCore handle for one sequence: it runs the three
scan phases + merge lattices in C and then serves the overlay range queries
(popcount / longest-run) that seed refinement needs.  Events are either
generated natively from the 2-bit code (host path) or injected from the
CUDA event kernels (see scan_events.py), with the event pass's packed
overlay as the overlay cache that host generation would have built
(set_overlay).

The port's copy of ribbit_tpu/core.py, which it may not import.  The
library comes from the port's native._compile, which raises when the C
core does not build; get_core_lib never returns None.  It builds
ribbit_tpu_torch/csrc/refine_rounds.c in place of csrc/ribbit_refine.c:
that file includes the refinement core whole and adds the batched route's
round entries (round_requests, round_emit), which need the session's
handle, so they live in this library.  For the same reason it builds
ribbit_tpu_torch/csrc/core_phases.c in place of csrc/ribbit_core.c: that
file includes the core whole and exports its scan cut into phases
(ribbit_core_scan_phase), which CoreSession.scan calls one span at a time.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import numpy as np

from . import tracing
from .config import RibbitConfig
from .native import _compile, _CSRC, _PORT_CSRC


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
    so = _compile([_PORT_CSRC / "core_phases.c",
                   _PORT_CSRC / "refine_rounds.c", _CSRC / "ribbit_align.c",
                   _CSRC / "ribbit_vote.c", _CSRC / "ribbit_events.c"],
                  includes=[_CSRC / "ribbit_core.c",
                            _CSRC / "ribbit_refine.c"])
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
    lib.ribbit_core_scan_phase.restype = ctypes.c_int64
    lib.ribbit_core_scan_phase.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ribbit_core_get_seeds.restype = None
    lib.ribbit_core_get_seeds.argtypes = [ctypes.c_void_p, P64]
    lib.ribbit_core_overlay_bitcount.restype = ctypes.c_int64
    lib.ribbit_core_overlay_bitcount.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
    lib.ribbit_core_overlay_longest_run.restype = ctypes.c_int64
    lib.ribbit_core_overlay_longest_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
    lib.ribbit_core_overlay_alloc.restype = ctypes.c_int64
    lib.ribbit_core_overlay_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                              ctypes.c_int64]
    lib.ribbit_core_overlay_row.restype = ctypes.POINTER(ctypes.c_int32)
    lib.ribbit_core_overlay_cache_max.restype = ctypes.c_int64
    lib.ribbit_core_overlay_cache_max.argtypes = []
    lib.ribbit_core_overlay_row.argtypes = [ctypes.c_void_p, ctypes.c_int32]
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
    P_ROUND = ctypes.POINTER(_CRound)
    PE = ctypes.POINTER(_CEmit)
    lib.ribbit_round_requests.restype = P_ROUND
    lib.ribbit_round_requests.argtypes = [
        ctypes.c_void_p, P8, PU8, P8, ctypes.c_int64, P64, P64,
        ctypes.c_int64, ctypes.c_int64, P64, P64, P64, P64, ctypes.c_int32]
    lib.ribbit_round_free.restype = None
    lib.ribbit_round_free.argtypes = [P_ROUND]
    lib.ribbit_round_emit.restype = PE
    lib.ribbit_round_emit.argtypes = [
        P_ROUND, P8, PU8, ctypes.c_int64, P64, P64, ctypes.c_int64,
        ctypes.c_char_p, P64, P64, P64, P64, ctypes.c_char_p, P64, P64,
        ctypes.c_int32]
    lib.ribbit_emit_free.restype = None
    lib.ribbit_emit_free.argtypes = [PE]
    _lib = lib
    _tried = True
    return _lib


_P64 = ctypes.POINTER(ctypes.c_int64)
_P8 = ctypes.POINTER(ctypes.c_int8)


class _CRound(ctypes.Structure):
    """RibbitRound (ribbit_tpu_torch/csrc/refine_rounds.c)."""
    _fields_ = [("n", ctypes.c_int64)] + [
        (f, _P64) for f in ("item", "cand", "a_start", "a_len", "atom",
                            "unit", "read_off", "ref_off")] + [
        ("reads", _P8), ("refs", _P8)]


class _CEmit(ctypes.Structure):
    """RibbitEmit (ribbit_tpu_torch/csrc/refine_rounds.c)."""
    _fields_ = [("text", ctypes.POINTER(ctypes.c_char)),
                ("text_len", ctypes.c_int64), ("nlines", ctypes.c_int64),
                ("npend", ctypes.c_int64)] + [
        (f, _P64) for f in ("line_req", "p_start", "p_end", "p_req",
                            "p_child")]


class Requests(NamedTuple):
    """One round's alignment requests, in item order (RibbitRound).
    Request k came from pending item item[k]: candidate cand[k] of
    possible_motifs (motifs up to 10 bp), or -1 for a longer motif's one
    request.  It aligns reads[read_off[k]:read_off[k+1]] (SSW codes of the
    genome from a_start[k], a_len[k] long but cut at the contig's end)
    against refs[ref_off[k]:ref_off[k+1]] (the motif's first atom[k] bases,
    codes 0-3, tiled to the pseudo-perfect repeat's length); unit[k] is a
    short motif's unit after the atomicity shift, -1 for a longer one."""
    item: np.ndarray
    cand: np.ndarray
    a_start: np.ndarray
    a_len: np.ndarray
    atom: np.ndarray
    unit: np.ndarray
    reads: np.ndarray        # int8
    read_off: np.ndarray     # int64 [n + 1]
    refs: np.ndarray         # int8
    ref_off: np.ndarray      # int64 [n + 1]

    @property
    def n(self) -> int:
        return self.item.shape[0]


class Emitted(NamedTuple):
    """One round's output (RibbitEmit): BED lines, line j from request
    line_req[j], and the next round's items, the flank recursion's
    children: [p_start[j], p_end[j]) of request p_req[j]'s item, child
    number p_child[j]."""
    lines: List[str]
    line_req: np.ndarray
    p_start: np.ndarray
    p_end: np.ndarray
    p_req: np.ndarray
    p_child: np.ndarray


def _arr(ptr, n: int, dtype) -> np.ndarray:
    """A numpy copy of n values at a C pointer."""
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, (n,)).astype(dtype, copy=True)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


# the core stores event/emission positions as i32 (an order of magnitude
# above the longest real chromosome); contigs at or past this length are
# auto-chunked by the pipeline (process_sequence routes them through
# process_sequence_chunked) instead of reaching a CoreSession
MAX_CONTIG = 2**31 - 64

def overlay_cache_max() -> int:
    """The longest contig (bp) that gets a packed overlay cache, by host
    generation's rule (RIBBIT_OVERLAY_CACHE_MAX, default 256 Mi bp), as the
    C core reads it."""
    return get_core_lib().ribbit_core_overlay_cache_max()


# ribbit_core_scan's phases, in order (csrc/core_phases.c), by span name
SCAN_PHASES = ("replay.generate", "replay.perfect", "replay.substitution",
               "replay.anchored", "replay.merge")


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
        with tracing.span("replay.set_events",
                          events=sum(len(g[0]) for g in (perf, q7, q6))):
            for group in (perf, q7, q6):
                for arr in group:
                    a, ptr = p(arr)
                    keep.append(a)
                    ptrs.append(ptr)
            self._events_keepalive = keep
            self.lib.ribbit_core_set_events(self.handle, *ptrs)

    def set_overlay(self, words) -> int:
        """Fill the C core's packed overlay cache from `words`, int32
        [nmotifs, 2 ceil(L / 64)] on any device (scan_events.EventStreams'
        overlay): each row is copied straight into the row the session
        allocates for it, so the host holds the words once.  The copies
        run on the current stream, which on the pipeline's threads is the
        one that made the words (torch's default stream of the device;
        neither thread sets another), so they follow the event pass.  Call
        it after set_events and before scan.  Returns the rows filled, 0
        where host generation's cache rule declines (L past
        RIBBIT_OVERLAY_CACHE_MAX); raises ValueError for another shape,
        the cache then unset.  Span "replay.overlay" (the bytes copied,
        the rows)."""
        import torch
        with tracing.span("replay.overlay") as sp:
            nrows, nw32 = words.shape
            if words.dtype != torch.int32:
                raise ValueError(f"overlay words: want int32, got "
                                 f"{words.dtype}")
            n = self.lib.ribbit_core_overlay_alloc(
                self.handle, nrows, nw32 // 2 if nw32 % 2 == 0 else -1)
            if n == -2:
                raise MemoryError("overlay cache: out of host memory")
            if n < 0:
                raise ValueError(f"overlay words [{nrows}, {nw32}] do not fit "
                                 f"{self.cfg.nmotifs} motifs of a "
                                 f"{self.code.shape[0]} bp contig")
            try:
                for d in range(n):
                    row = np.ctypeslib.as_array(
                        self.lib.ribbit_core_overlay_row(self.handle, d),
                        (nw32,))
                    torch.from_numpy(row).copy_(words[d])
            except BaseException:
                self.drop_overlay()
                raise
            sp.set(bytes=n * nw32 * 4, rows=n)
        return n

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
        """Runs scan+lattices+merge, a span a phase (SCAN_PHASES, each but
        generation counting the seeds it made); returns int64[N, 4] seed
        array (start, end, mlen, rank) in emission order."""
        for k, name in enumerate(SCAN_PHASES):
            with tracing.span(name) as sp:
                n = self.lib.ribbit_core_scan_phase(self.handle, k)
                if k:
                    sp.set(seeds=n)
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
        """Native refinement of the merged seed stream -> BED lines (span
        "refine": seeds in, lines out)."""
        with tracing.span("refine", seeds=len(seeds)) as sp:
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
                self.code.shape[0], cfg.min_motif, cfg.max_motif,
                cfg.min_shift, min_len.ctypes.data_as(P64),
                perf_units.ctypes.data_as(P64), tbl,
                sequence_id.encode("latin-1", errors="replace"),
                seeds.ctypes.data_as(P64), seeds.shape[0], self.nthreads,
                ctypes.byref(out_len))
            text = ctypes.string_at(buf, out_len.value).decode("latin-1")
            self.lib.ribbit_buffer_free(buf)
            lines = text.splitlines()
            sp.set(lines=len(lines))
        return lines

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

    def round_requests(self, translated: np.ndarray, seed_start, seed_end,
                       mlen, midx, nthreads: int = 0) -> Requests:
        """The alignment requests of a round's pending items (seed_start,
        seed_end, motif length, overlay channel; int arrays of one length)
        on the batched route: the n-trim, the overlay gate (a run of 3,
        as the C pool asks), the motif (possible_motifs up to 10 bp, else
        the memoised diagonal vote) and each request's read (from
        `translated`, the SSW codes of the sequence) and pseudo-perfect
        ref, in item order, on nthreads threads (0: RIBBIT_THREADS or
        every core)."""
        tbl, min_len, perf_units = self._refine_tables()
        translated = np.ascontiguousarray(translated, dtype=np.int8)
        if translated.shape[0] != self.code.shape[0]:
            raise ValueError("translated and the session's code differ in "
                             "length")
        cols = [_i64(a) for a in (seed_start, seed_end, mlen, midx)]
        n = cols[0].shape[0]
        if any(c.shape != (n,) for c in cols):
            raise ValueError("the item arrays differ in length")
        r = self.lib.ribbit_round_requests(
            self.handle, self.code.ctypes.data_as(_P8),
            self.n_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            translated.ctypes.data_as(_P8), self.code.shape[0],
            min_len.ctypes.data_as(_P64), perf_units.ctypes.data_as(_P64),
            tbl, n, *(c.ctypes.data_as(_P64) for c in cols), nthreads)
        try:
            c = r.contents
            fields = [_arr(getattr(c, f), c.n, np.int64) for f in
                      ("item", "cand", "a_start", "a_len", "atom", "unit")]
            read_off = _arr(c.read_off, c.n + 1, np.int64)
            ref_off = _arr(c.ref_off, c.n + 1, np.int64)
            return Requests(*fields, _arr(c.reads, read_off[-1], np.int8),
                            read_off, _arr(c.refs, ref_off[-1], np.int8),
                            ref_off)
        finally:
            self.lib.ribbit_round_free(r)

    def round_emit(self, req: Requests, sequence_id: str, seed_start,
                   seed_end, mlen, seed_type, cigar: np.ndarray,
                   cigar_off, cigar_len, nthreads: int = 0) -> Emitted:
        """A round's BED lines and next items from its requests (made from
        these item arrays) and each request's cigar,
        cigar[cigar_off[k]:cigar_off[k] + cigar_len[k]] (uint8 or bytes;
        length 0 for none): process_cigar_*, the gates, the BED line and
        the flank recursion, on nthreads threads."""
        tbl, min_len, perf_units = self._refine_tables()
        items = [_i64(a) for a in (seed_start, seed_end, mlen, seed_type)]
        if any(a.shape != items[0].shape for a in items):
            raise ValueError("the item arrays differ in length")
        cig_off, cig_len = _i64(cigar_off), _i64(cigar_len)
        cigar = np.frombuffer(cigar, np.uint8) if isinstance(
            cigar, bytes) else np.ascontiguousarray(cigar, np.uint8)
        n = req.n
        if cig_off.shape != (n,) or cig_len.shape != (n,):
            raise ValueError(f"{n} requests need {n} cigar offsets and "
                             "lengths")
        if n and ((cig_off < 0) | (cig_len < 0)
                  | (cig_off + cig_len > cigar.shape[0])).any():
            raise ValueError("a cigar lies outside the buffer")
        if n and ((req.item < 0) | (req.item >= items[0].shape[0])).any():
            raise ValueError("a request's item is not among the items")
        if (req.read_off[-1] != req.reads.shape[0]
                or req.ref_off[-1] != req.refs.shape[0]
                or (n and ((req.atom < 1)
                           | (req.atom > np.diff(req.ref_off))).any())):
            raise ValueError("the requests' offsets or motifs do not fit "
                             "their buffers")
        keep = [_i64(getattr(req, f)) for f in
                ("item", "cand", "a_start", "a_len", "atom", "unit",
                 "read_off", "ref_off")]
        reads = np.ascontiguousarray(req.reads, np.int8)
        refs = np.ascontiguousarray(req.refs, np.int8)
        c = _CRound(n, *(a.ctypes.data_as(_P64) for a in keep),
                    reads.ctypes.data_as(_P8), refs.ctypes.data_as(_P8))
        em = self.lib.ribbit_round_emit(
            ctypes.byref(c), self.code.ctypes.data_as(_P8),
            self.n_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.code.shape[0], min_len.ctypes.data_as(_P64),
            perf_units.ctypes.data_as(_P64), tbl,
            sequence_id.encode("latin-1", errors="replace"),
            *(a.ctypes.data_as(_P64) for a in items),
            cigar.ctypes.data_as(ctypes.c_char_p),
            cig_off.ctypes.data_as(_P64), cig_len.ctypes.data_as(_P64),
            nthreads)
        try:
            e = em.contents
            text = ctypes.string_at(e.text, e.text_len).decode("latin-1")
            return Emitted(text.splitlines(),
                           _arr(e.line_req, e.nlines, np.int64),
                           *(_arr(getattr(e, f), e.npend, np.int64) for f in
                             ("p_start", "p_end", "p_req", "p_child")))
        finally:
            self.lib.ribbit_emit_free(em)

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
