"""The host route of the port (--backend host): every stage in the C core,
or in the Python engine.

The port's copy of the host half of ribbit_tpu/pipeline.py, which it may
not import: the core engine's streaming and C-pool branches of
_process_core, the Python engine, process_sequence with its over-cap
auto-chunking, the chunked paths and the host process_fasta_records.
Left out: the `tpu` branches and the silent moves to the Python engine
when the C core cannot be built (here the build raises).

  engine="core":   encode -> CoreSession (threaded C generation, scanners,
                   lattices, seed merge) -> refinement in the C pool
  engine="python": encode -> numpy scan arrays (scan_host) -> scanner
                   replays and lattices (events, lattice) -> three-pointer
                   seed merge -> process_seed / process_seed_motifwise,
                   aligned by the C engine -> BED lines

The Python engine is the repository's semantic specification and far
slower than the C core; pipeline.py runs it over the dense device scan
(scan_dense) with the same _process_python.  Its contigs run one at a
time, on the calling thread.

With RIBBIT_BATCHED_REFINE set (any non-empty value), the core engine's
refinement runs through refine_batched instead, with its SSW forward
passes on `device` (the CUDA kernels, or their plain versions for
device="cpu"), and records are processed one at a time: the card is one
serial resource.  With RIBBIT_PY_REFINE set, it runs through the Python
engine's refinement over the C core's seeds (a cross-check).
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from . import scan_host
from .config import (RANK_A, RANK_N, RANK_P, RANK_S,
                     WINDOW_BITCOUNT_ANCHORED, WINDOW_BITCOUNT_SUBSTITUTION,
                     RibbitConfig)
from .core import MAX_CONTIG, CoreSession
from .encode import encode
from .events import run_anchored_scan, run_perfect_scan, run_substitution_scan
from .eventstitch import capture_runs_host, scan_events_segmented
from .fasta import read_fasta
from .refine import (longest_continuous_matches, process_seed,
                     process_seed_motifwise)

ENGINES = ("core", "python")
RECURSION_LIMIT = 1_000_000


def batched_refine_requested() -> bool:
    """True when RIBBIT_BATCHED_REFINE asks for device-batched refinement."""
    return bool(os.environ.get("RIBBIT_BATCHED_REFINE"))


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def _allow_deep_recursion() -> None:
    """The lattices and processSeed recurse in proportion to local seed
    structure (the JAX package raises the limit when its pipeline is
    imported)."""
    if sys.getrecursionlimit() < RECURSION_LIMIT:
        sys.setrecursionlimit(RECURSION_LIMIT)


class _BitmapCounter:
    """bitcount(midx, start, end) over a bool [NSHIFTS, L] matrix."""

    def __init__(self, bitmaps: np.ndarray):
        self.bitmaps = bitmaps

    def __call__(self, midx: int, start: int, end: int) -> int:
        if start < 0:
            start = 0
        return int(np.count_nonzero(self.bitmaps[midx, start:end]))


def _refine_seeds(seeds, sequence_id: str, sequence: str, L: int,
                  code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig,
                  emit, longest_run_for_channel) -> None:
    """Dispatch the merged seed stream into the two refinement paths
    (fasta_utils.cpp:224-240).  seeds: iterable of (start, end, mlen, rank);
    longest_run_for_channel(midx) -> callable(a, b) -> longest overlay run."""
    _allow_deep_recursion()
    for seed_start, seed_end, seed_mlen, seed_type in seeds:
        if seed_type == RANK_N:
            continue
        if seed_end - seed_start >= 0.9 * seed_mlen:
            clr = longest_run_for_channel(cfg.motif_channel(seed_mlen))
            if seed_mlen <= 10:
                process_seed_motifwise(seed_start, seed_end, seed_mlen,
                                       seed_type, sequence_id, sequence, L,
                                       clr, code, n_mask, cfg, emit)
            else:
                process_seed(seed_start, seed_end, seed_mlen, seed_type,
                             sequence_id, sequence, L, clr, code, n_mask,
                             cfg, emit)


def scan_host_arrays(code: np.ndarray, n_mask: np.ndarray,
                     cfg: RibbitConfig):
    """(eq, anchors, overlay, qual7, qual6) by the numpy spec (scan_host):
    the contract of scan_dense.scan_arrays."""
    eq = scan_host.match_bitmaps(code, cfg)
    anchors = scan_host.anchor_bitmaps(eq, cfg)
    overlay = scan_host.overlay_bitmaps(eq, anchors, cfg)
    return (eq, anchors, overlay,
            scan_host.window_qualified(eq, n_mask,
                                       WINDOW_BITCOUNT_SUBSTITUTION),
            scan_host.window_qualified(overlay, n_mask,
                                       WINDOW_BITCOUNT_ANCHORED))


def _merged(perfect, substut, anchored):
    """The final 3-pointer merge by seed start; P wins ties over S over A
    (fasta_utils.cpp:181-242)."""
    pi = si = ai = 0
    smallest_type = -1
    while pi < len(perfect) or si < len(substut) or ai < len(anchored):
        smallest = (1 << 64) - 1
        if pi < len(perfect) and smallest > perfect[pi][0]:
            smallest = perfect[pi][0]
            smallest_type = RANK_P
        if si < len(substut) and smallest > substut[si][0]:
            smallest = substut[si][0]
            smallest_type = RANK_S
        if ai < len(anchored) and smallest > anchored[ai][0]:
            smallest = anchored[ai][0]
            smallest_type = RANK_A
        if smallest_type == RANK_P:
            seed = perfect[pi]
            pi += 1
        elif smallest_type == RANK_S:
            seed = substut[si]
            si += 1
        else:
            seed = anchored[ai]
            ai += 1
        yield seed


def python_seeds(eq, overlay, qual7, qual6, n_mask: np.ndarray,
                 cfg: RibbitConfig) -> list:
    """The scanner replays and lattices over the scan arrays: the merged
    seed list, (start, end, mlen, rank) each."""
    _allow_deep_recursion()
    raw_bitcount = _BitmapCounter(eq)
    perfect = run_perfect_scan(eq, n_mask, raw_bitcount, cfg)
    substut = run_substitution_scan(qual7, n_mask, raw_bitcount, perfect, cfg)
    anchored = run_anchored_scan(qual6, n_mask, _BitmapCounter(overlay),
                                 perfect, substut, cfg)
    return list(_merged(perfect, substut, anchored))


def _process_python(sequence_id: str, sequence: str, cfg: RibbitConfig,
                    emit, scan=scan_host_arrays) -> None:
    """The Python engine over one sequence, on the calling thread;
    scan(code, n_mask, cfg) gives the five scan arrays."""
    L = len(sequence)
    code, n_mask = encode(sequence)
    eq, _anchors, overlay, qual7, qual6 = scan(code, n_mask, cfg)
    seeds = python_seeds(eq, overlay, qual7, qual6, n_mask, cfg)

    def longest_run_for_channel(midx: int):
        ch = overlay[midx]
        return lambda a, b: longest_continuous_matches(ch[a:b])

    _refine_seeds(seeds, sequence_id, sequence, L, code, n_mask, cfg, emit,
                  longest_run_for_channel)


def _process_core(sequence_id: str, sequence: str, cfg: RibbitConfig,
                  emit, nthreads: int = 0, device="cuda") -> None:
    L = len(sequence)
    code, n_mask = encode(sequence)
    sess = CoreSession(code, n_mask, cfg, nthreads=nthreads)
    try:
        drop_min = int(os.environ.get("RIBBIT_OVERLAY_DROP_MIN", 64_000_000))
        batched = batched_refine_requested()
        py_refine = bool(os.environ.get("RIBBIT_PY_REFINE"))
        if (not batched and not py_refine
                and os.environ.get("RIBBIT_STREAM", "1") != "0"):
            # streaming path: the serial anchored-consume walk overlaps the
            # refinement pool (ribbit_scan_refine); byte-identical to
            # scan()+refine().  Large contigs release the packed overlay at
            # a quiescent point between the scan and the refine tail (same
            # memory profile as the two-phase path's drop).
            for line in sess.scan_refine(sequence, sequence_id,
                                         drop_overlay=L >= drop_min):
                emit(line)
            return
        seeds = sess.scan()
        if batched:
            from .refine_batched import refine_batched
            for line in refine_batched(seeds, sequence, sequence_id, code,
                                       n_mask, sess, cfg, device=device):
                emit(line)
            return
        if py_refine:
            # python refinement over the native seed stream (cross-check)
            def longest_run_for_channel(midx: int):
                return lambda a, b: sess.overlay_longest_run(midx, a, b)
            _refine_seeds(seeds.tolist(), sequence_id, sequence, L, code,
                          n_mask, cfg, emit, longest_run_for_channel)
            return
        # large contigs: hand back the packed overlay cache (~12.4 B/bp)
        # before refinement — its only remaining consumer is the
        # has-run-of-3 gate, which recomputes with early exit
        if L >= drop_min:
            sess.drop_overlay()
        for line in sess.refine(seeds, sequence, sequence_id):
            emit(line)
    finally:
        sess.close()


def process_sequence(sequence_id: str, sequence: str, cfg: RibbitConfig,
                     out: Optional[List[str]] = None,
                     nthreads: int = 0, device="cuda",
                     engine: str = "core") -> List[str]:
    """Returns the BED lines for one sequence (11 tab-separated columns,
    matching ribbit.cpp:199-204 / parse_seed.cpp:434-437).  engine is
    "core" (the C core) or "python" (the Python engine over the numpy
    scan arrays)."""
    check_engine(engine)
    lines: List[str] = out if out is not None else []
    if len(sequence) == 0:
        return lines
    if engine == "python":
        _process_python(sequence_id, sequence, cfg, lines.append)
        return lines
    if len(sequence) >= MAX_CONTIG:
        # past the native core's i32 position range: auto-chunk at
        # big-N-run midpoints (exact splits) instead of erroring out
        print(f"ribbit-tpu-torch: {sequence_id} exceeds 2^31-64 bp; "
              "auto-chunking", file=sys.stderr)
        # chunk_size/halo relative to the contig so chunk spans stay
        # well under the cap and never route back here
        over_chunk = min(8 << 20, len(sequence) // 8)
        lines.extend(process_sequence_chunked(
            sequence_id, sequence, cfg, chunk_size=over_chunk,
            halo=min(1 << 16, over_chunk // 4), strict=True,
            device=device))
        return lines
    _process_core(sequence_id, sequence, cfg, lines.append,
                  nthreads=nthreads, device=device)
    return lines


def _choose_splits(n_mask: np.ndarray, chunk_size: int,
                   min_gap: int = 512, strict: bool = False) -> List[int]:
    """Split points for chunked processing, preferentially at the midpoints
    of N-runs >= min_gap.

    Rationale (exactness): no seed, window, or qualified run crosses an N
    position, and anchor-qualifying eq-runs are < 2*max_shift ~ 204 bp — a
    run crossing the midpoint of an N-run >= 512 is itself >= 410 long and
    can never be an anchor.  Chunks that overlap by >= half the N-run
    therefore reproduce the whole-contig scan exactly around the split; the
    only possible divergence is the reference's positional-index quirk in
    the anchored coverage votes (parse_anchored_shiftxor.cpp:441-526),
    which reads unrelated early list entries.  Splits away from N-runs
    (dense contigs) fall back to raw offsets and rely on the halo."""
    L = n_mask.shape[0]
    splits = []
    target = chunk_size
    # N-runs >= min_gap
    idx = np.flatnonzero(n_mask)
    runs = []
    if idx.size:
        brk = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate(([idx[0]], idx[brk + 1]))
        ends = np.concatenate((idx[brk] + 1, [idx[-1] + 1]))
        runs = [(int(s), int(e)) for s, e in zip(starts, ends)
                if e - s >= min_gap]
    while target < L - chunk_size // 2:
        # nearest qualifying N-run midpoint within +-chunk_size/2
        best = None
        for s, e in runs:
            mid = (s + e) // 2
            if abs(mid - target) <= chunk_size // 2:
                if best is None or abs(mid - target) < abs(best - target):
                    best = mid
        if best is not None:
            splits.append(best)
        elif not strict:
            splits.append(target)
        # strict mode: no qualifying N-run -> no split here (stay exact)
        splits_last = splits[-1] if splits else 0
        nxt = max(target, splits_last) + chunk_size
        if nxt <= target:
            break
        target = nxt
    return splits


def process_sequence_chunked(sequence_id: str, sequence: str,
                             cfg: RibbitConfig,
                             chunk_size: int = 8 << 20,
                             halo: int = 1 << 16,
                             workers: Optional[int] = None,
                             strict: bool = False,
                             device="cuda") -> List[str]:
    """Chunked processing of one long contig, BYTE-IDENTICAL to the
    whole-contig run at ANY split points.

    Chunks are halo-extended windows; each window runs the threaded native
    generation in run-capture mode (eventstitch.capture_runs_host), the
    per-chunk event streams are clipped/stitched into the exact whole-
    contig streams, and the order-dependent scanner/lattice replay runs
    ONCE globally (O(events), cheap) before threaded refinement.  This
    removes the old per-chunk replay's exposure to the reference's
    positional-index vote quirk (parse_anchored_shiftxor.cpp:441-526) and
    the big-N-run split-point requirement; memory stays bounded (the
    packed overlay cache is never built: capture mode skips it and the
    injected-events session recomputes range queries on demand).

    `workers` bounds this path's native thread count; `halo` and `strict`
    apply only to the over-cap split fallback below (the stitched path's
    capture halo is the fixed, exactness-validated eventstitch.HALO).

    Contigs past the native core's i32 position range cannot hold a global
    session and fall back to independent split processing
    (_process_chunked_split; exact only at big-N-run splits).  `device` is
    where refine_batched's forward passes run for the contigs and chunks
    that go through process_sequence."""
    L = len(sequence)
    if L <= chunk_size + chunk_size // 2:
        return process_sequence(sequence_id, sequence, cfg, device=device)
    if L >= MAX_CONTIG:
        # strict=True: prefer exact big-N-run splits; the no-N-run branch
        # inside prints the best-effort warning before degrading, keeping
        # the documented byte-identical contract honest for over-cap input
        return _process_chunked_split(sequence_id, sequence, cfg,
                                      chunk_size=chunk_size, halo=halo,
                                      workers=workers, strict=True,
                                      device=device)
    ncpu = workers or os.cpu_count() or 1
    code, n_mask = encode(sequence)
    perf, q7, q6 = scan_events_segmented(
        code, n_mask, cfg, extractor=capture_runs_host,
        seg_size=chunk_size)
    sess = CoreSession(code, n_mask, cfg, nthreads=ncpu)
    try:
        sess.set_events(perf, q7, q6)
        seeds = sess.scan()
        return sess.refine(seeds, sequence, sequence_id)
    finally:
        sess.close()


def _process_chunked_split(sequence_id: str, sequence: str,
                           cfg: RibbitConfig,
                           chunk_size: int = 8 << 20,
                           halo: int = 1 << 16,
                           workers: Optional[int] = None,
                           strict: bool = False,
                           device="cuda") -> List[str]:
    """Independent-chunk processing (the pre-stitch design): splits at
    big-N-run midpoints when possible, raw offsets otherwise; each chunk
    replays its own lattices.  Only used for contigs past the native
    core's i32 range; exact at N-run splits, best-effort within +-halo of
    raw cuts."""
    L = len(sequence)
    if L <= chunk_size + chunk_size // 2:
        return process_sequence(sequence_id, sequence, cfg, device=device)

    _code, n_mask = encode(sequence)
    splits = _choose_splits(n_mask, chunk_size, strict=strict)
    if strict and not splits and L >= MAX_CONTIG:
        # over-cap contig with no big-N-run split points: raw-offset splits
        # with halo are the only way through the native core's i32 range.
        # Output can differ from a (hypothetical) whole-contig run within
        # +-halo of each cut; real genomes always have qualifying N runs.
        print(f"ribbit-tpu-torch: {sequence_id}: no N-run split points; "
              "using raw-offset chunking (output near cut points is "
              "best-effort)", file=sys.stderr)
        strict = False
        splits = _choose_splits(n_mask, chunk_size, strict=False)
    if not splits:
        return process_sequence(sequence_id, sequence, cfg, device=device)
    if strict:
        # N-run-midpoint splits need no halo: no seed, window, qualified
        # run, or anchor-eligible eq-run can span the midpoint of an N-run
        # >= 512 (runs through it are >= 410 long, above the 2*max_shift
        # anchor bound), so each chunk reproduces the whole-contig scan on
        # its own interval exactly; extending into foreign context would
        # instead perturb the order-dependent lattices
        halo = 0
    bounds = [0] + splits + [L]

    tasks = []
    for i in range(len(bounds) - 1):
        core_lo, core_hi = bounds[i], bounds[i + 1]
        lo = max(0, core_lo - halo)
        hi = min(L, core_hi + halo)
        tasks.append((lo, hi, core_lo, core_hi))

    ncpu = os.cpu_count() or 1
    if workers is None:
        workers = min(ncpu, len(tasks))

    def run_chunk(t):
        lo, hi, core_lo, core_hi = t
        sub = sequence[lo:hi]
        lines = process_sequence(sequence_id, sub, cfg, nthreads=ncpu,
                                 device=device)
        out = []
        for line in lines:
            cols = line.split("\t")
            start = int(cols[1]) + lo
            if core_lo <= start < core_hi:
                cols[1] = str(start)
                cols[2] = str(int(cols[2]) + lo)
                out.append("\t".join(cols))
        return out

    with ThreadPoolExecutor(max_workers=workers) as ex:
        results = list(ex.map(run_chunk, tasks))
    lines: List[str] = []
    for r in results:
        lines.extend(r)
    return lines


def process_fasta_records(path: str, cfg: RibbitConfig,
                          workers: Optional[int] = None,
                          chunk_size: Optional[int] = None,
                          skip=None, device="cuda", engine: str = "core"):
    """Stream (name, length, lines) per FASTA record, in file order.

    Contigs are independent units in the reference (ribbit.cpp:269-280), so
    the core engine fans them out over a thread pool with byte-identical
    output.  The native core releases the GIL, so Python threads scale;
    the Python engine runs them one at a time.  `skip` is an optional
    set of contig names to pass over (resume support) — skipped records
    yield (name, length, None).  `device` is where refine_batched's
    forward passes run when RIBBIT_BATCHED_REFINE is set."""
    check_engine(engine)
    records = list(read_fasta(path))
    ncpu = os.cpu_count() or 1
    todo = [(i, sid, seq) for i, (sid, seq) in enumerate(records)
            if not (skip and sid in skip)]
    if workers is None:
        workers = min(ncpu, len(todo)) or 1

    serial = (engine != "core" or workers <= 1 or len(todo) <= 1
              or batched_refine_requested())

    def run_one(rec):
        _i, sid, seq = rec
        if engine == "core" and chunk_size \
                and len(seq) > chunk_size + chunk_size // 2:
            # long contigs: bounded-memory chunked processing, byte-exact
            # at any cut (per-chunk event capture + stitch + one global
            # lattice replay)
            return process_sequence_chunked(sid, seq, cfg,
                                            chunk_size=chunk_size,
                                            device=device)
        # deliberately oversubscribe: contig sizes are highly imbalanced
        # and work-conserving scheduling beats static core partitioning
        return process_sequence(sid, seq, cfg,
                                nthreads=0 if serial else ncpu,
                                device=device, engine=engine)

    if serial:
        todo_ids = {t[0] for t in todo}
        for i, (sid, seq) in enumerate(records):
            yield sid, len(seq), (run_one((i, sid, seq))
                                  if i in todo_ids else None)
    else:
        # yield incrementally in file order so callers can checkpoint each
        # contig as it completes
        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs = {t[0]: ex.submit(run_one, t) for t in todo}
            for i, (sid, seq) in enumerate(records):
                f = futs.get(i)
                yield sid, len(seq), (f.result() if f is not None else None)


def process_fasta(path: str, cfg: RibbitConfig,
                  workers: Optional[int] = None,
                  chunk_size: Optional[int] = None,
                  device="cuda", engine: str = "core") -> List[str]:
    """Whole-FASTA convenience wrapper: flat BED line list in file order."""
    lines: List[str] = []
    for _sid, _n, r in process_fasta_records(path, cfg, workers, chunk_size,
                                             device=device, engine=engine):
        if r:
            lines.extend(r)
    return lines
