"""Seed refinement: motif inference, alignment vs a pseudo-perfect repeat,
CIGAR processing, emission, and flank recursion.

Ports (with file:line citations into the reference sources):
  - longestContinuousMatches    parse_seed.cpp:26-44
  - mostFrequentMotif           parse_seed.cpp:259-315
  - mostFrequentLongerMotif     parse_seed.cpp:153-256 (diagonal voting, ±2 jitter)
  - processSeed                 parse_seed.cpp:318-464 (incl. flank recursion)
  - possibleMotifs              parse_smallmotif_seed.cpp:76-188
  - calculateMotifUnits         parse_smallmotif_seed.cpp:26-72
  - processSeedMotifWise        parse_smallmotif_seed.cpp:190-288

Float expressions that the reference evaluates in C++ `float` (purity, the
pseudo-perfect-repeat length) are done in np.float32 to keep emitted values
and truncations bit-identical.

The benchmark's frozen copy of the repository's Python refinement:
the motif vote and the alignments run in numpy (align.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .config import RibbitConfig, PURITY_THRESHOLD, CONTINUOUS_ONES_THRESHOLD
from . import bitutils
from .align import align_strings
from .cigarproc import process_cigar_with_pruning, process_cigar_motifwise

EmitFn = Callable[[str], None]


def format_purity(p: np.float32) -> str:
    """C++ `ostream << float` default formatting: 6 significant digits."""
    return f"{float(p):.6g}"


def longest_continuous_matches(bits: np.ndarray) -> int:
    """Longest run of 1s (parse_seed.cpp:26-44)."""
    if bits.size == 0:
        return 0
    best = cur = 0
    # vectorized run-length: positions of 0s split the array
    idx = np.flatnonzero(~bits)
    if idx.size == 0:
        return int(bits.size)
    prev = -1
    for z in idx.tolist():
        cur = z - prev - 1
        if cur > best:
            best = cur
        prev = z
    cur = bits.size - prev - 1
    return int(max(best, cur))


def _ppr_length(seed_sequence_length: int, motif_length: int) -> int:
    """int ppr = ssl + m + ((1-PURITY_THRESHOLD)*ssl) with C++ float
    arithmetic and int truncation (parse_seed.cpp:381)."""
    f = (np.float32(1) - PURITY_THRESHOLD) * np.float32(seed_sequence_length)
    return int(np.float32(seed_sequence_length + motif_length) + f)


def _build_ppr(motif: str, ppr_length: int) -> str:
    s = ""
    while len(s) <= ppr_length:
        s += motif
    return s[:ppr_length]  # Align() truncates the ref to ppr_length anyway


def most_frequent_motif(code: np.ndarray, seed_start: int,
                        seed_sequence_length: int, motif_length: int,
                        sequence_length: int) -> int:
    """mostFrequentMotif (parse_seed.cpp:259-315): most frequent 2m-bit
    window; ties broken by first window to reach the count."""
    mask = (1 << (2 * motif_length)) - 1
    seed_end = seed_start + seed_sequence_length
    if seed_end > sequence_length - 1:
        seed_end = sequence_length - 1
    window = 0
    counts: dict[int, int] = {}
    max_freq = 0
    maxfreq_motif = 0
    guard = 0.9 * motif_length - 1
    for j in range(seed_start, seed_end):
        window = ((window << 2) | int(code[j])) & mask
        if j - seed_start >= guard:
            c = counts.get(window, 0) + 1
            counts[window] = c
            if c > max_freq:
                max_freq = c
                maxfreq_motif = window
    return maxfreq_motif


def most_frequent_longer_motif(code: np.ndarray, n_mask: np.ndarray,
                               seed_start: int, seed_sequence_length: int,
                               motif_length: int, sequence_length: int) -> int:
    """mostFrequentLongerMotif (parse_seed.cpp:153-256), vectorized.

    Greedy diagonal voting with ±2 bp jitter per unit: every candidate row
    start walks downstream then upstream in ~m-sized jumps, choosing the
    jitter with the highest m-length match count at each step, plus a
    partial-prefix vote when the upstream walk overshoots the seed start.
    All row starts walk in lockstep as numpy batches; per greedy step each
    jitter is one [R, m] gather-compare.  The dot matrix (*MATRIX[row])[col]
    is (code[row]==code[col]) with N *columns* matching nothing.  Exactness
    notes vs the scalar loops:
      - inner i-loops break at the first invalid column; columns are monotone
        in i, so the break equals a contiguous validity mask
      - jitter tie-break: strict '>' scanning x = -2..2, zero counts never
        displace the initial x = -2 — replicated by the masked update order
      - row tie-break: strict '>' over ascending rows == np.argmax; an
        all-zero vote leaves mmotif_index at 0 (start of the *sequence*, a
        reference quirk)
    Cross-checked against the scalar loops in the repository's tests."""
    seed_end = seed_start + seed_sequence_length
    m = motif_length
    Lc = code.shape[0]
    ar_m = np.arange(m, dtype=np.int64)

    nrows = seed_end - m + 1 - seed_start
    if nrows <= 0:
        mmotif_index = 0
    else:
        rows = np.arange(seed_start, seed_end - m + 1, dtype=np.int64)
        row_codes = code[rows[:, None] + ar_m]          # [R, m]
        R = rows.shape[0]
        row_count = np.zeros(R, dtype=np.int64)

        def jitter_vote(col0: np.ndarray, active: np.ndarray, valid_of):
            """One greedy step for all rows: scan x = -2..2, return the
            winning (count, jitter) per row under strict-> update order."""
            best_cnt = np.zeros(R, dtype=np.int64)
            best_x = np.full(R, -2, dtype=np.int64)
            for x in (-2, -1, 0, 1, 2):
                cols = (col0 + x)[:, None] + ar_m       # [R, m]
                valid = valid_of(cols)
                colsc = np.clip(cols, 0, Lc - 1)
                eq = (row_codes == code[colsc]) & ~n_mask[colsc] & valid
                cnt = eq.sum(axis=1)
                upd = active & (cnt > best_cnt)
                best_cnt[upd] = cnt[upd]
                best_x[upd] = x
            return best_cnt, best_x

        # downstream walk: columns increase with i; invalid (>= seed_end) is
        # a suffix, equal to the scalar break (parse_seed.cpp:163-181)
        dstream = rows + m
        active = dstream < seed_end
        while active.any():
            best_cnt, best_x = jitter_vote(
                dstream, active, lambda cols: cols < seed_end)
            row_count[active] += best_cnt[active]
            dstream[active] += best_x[active] + m
            active &= dstream < seed_end

        # upstream walk: the scalar breaks at i where col < 0; columns
        # increase with i so that is only possible at i == 0 → a row whose
        # c0 < 0 scores 0 for that jitter (parse_seed.cpp:184-202)
        ustream = rows - m
        active = ustream > seed_start
        while active.any():
            best_cnt, best_x = jitter_vote(
                ustream, active, lambda cols: cols[:, :1] >= 0)
            row_count[active] += best_cnt[active]
            ustream[active] += best_x[active] - m
            active &= ustream > seed_start

        # partial-prefix vote (parse_seed.cpp:205-233): columns *decrease*
        # with i; col >= seed_end only possible at i == 0, col < seed_start
        # invalidates a suffix
        pf = (ustream < seed_start) & (seed_start - ustream < m)
        if pf.any():
            initial_lastrow = rows + m - 1
            pcindex = ustream + m - 1
            prefix_rows = m + (ustream - seed_start)
            best_cnt = np.zeros(R, dtype=np.int64)
            for x in (-2, -1, 0, 1, 2):
                cols = (pcindex + x)[:, None] - ar_m    # [R, m] decreasing
                rws = initial_lastrow[:, None] - ar_m
                valid = ((ar_m[None, :] < prefix_rows[:, None])
                         & (cols[:, :1] < seed_end)
                         & (cols >= seed_start))
                colsc = np.clip(cols, 0, Lc - 1)
                rwsc = np.clip(rws, 0, Lc - 1)
                eq = (code[rwsc] == code[colsc]) & ~n_mask[colsc] & valid
                cnt = eq.sum(axis=1)
                upd = pf & (cnt > best_cnt)
                best_cnt[upd] = cnt[upd]
            row_count[pf] += best_cnt[pf]

        if row_count.max() > 0:
            mmotif_index = int(rows[int(np.argmax(row_count))])
        else:
            mmotif_index = 0

    motif_unit = 0
    for c in code[mmotif_index:mmotif_index + m].tolist():
        motif_unit = (motif_unit << 2) | int(c)
    # QUIRK: uint256_t packing truncation for m > 128 (parse_seed.cpp:246-253)
    return motif_unit & ((1 << 256) - 1)


def _n_trimmed_length(n_mask: np.ndarray, seed_start: int, seed_end: int,
                      motif_length: int) -> int:
    """Trim the seed sequence at the first N (parse_seed.cpp:349-354)."""
    ssl = seed_end - seed_start + motif_length
    lim = seed_end + motif_length
    sub = n_mask[seed_start:lim]
    nz = np.flatnonzero(sub)
    if nz.size:
        return int(nz[0])
    return ssl


def process_seed(seed_start: int, seed_end: int, motif_length: int,
                 seed_type: int, sequence_id: str, sequence: str,
                 sequence_length: int, channel_longest_run,
                 code: np.ndarray, n_mask: np.ndarray,
                 cfg: RibbitConfig, emit: EmitFn) -> None:
    """processSeed (parse_seed.cpp:318-464): large-motif refinement with
    recursion into uncovered flanks.  channel_longest_run(a, b) -> longest
    run of 1s in the seed's overlay channel over [a, b)."""
    seed_sequence_length = _n_trimmed_length(n_mask, seed_start, seed_end,
                                             motif_length)
    seed_sequence = sequence[seed_start:seed_start + seed_sequence_length]

    if seed_end - seed_start < 0.9 * motif_length:
        return
    if channel_longest_run(seed_start, seed_end) < CONTINUOUS_ONES_THRESHOLD:
        return

    ppr_length = _ppr_length(seed_sequence_length, motif_length)
    if motif_length <= 10:
        motif_unit = most_frequent_motif(code, seed_start, seed_sequence_length,
                                         motif_length, sequence_length)
        atomicity = bitutils.atomicity(motif_unit, motif_length)
    else:
        motif_unit = most_frequent_longer_motif(code, n_mask, seed_start,
                                                seed_sequence_length,
                                                motif_length, sequence_length)
        atomicity = bitutils.atomicity_long(motif_unit, motif_length)

    if motif_length % atomicity != 0:
        return

    motif = bitutils.motif_to_string(motif_unit, motif_length)[:atomicity]

    ppr = _build_ppr(motif, ppr_length)
    alignment = align_strings(seed_sequence, ppr)
    if alignment is None or not alignment.cigar_string:
        return
    cigar_values, cigar_string, purity = process_cigar_with_pruning(
        seed_start, seed_sequence_length, alignment.cigar_string,
        atomicity, cfg.minimum_length)
    repeat_start, repeat_end, alignment_length, _mu = cigar_values

    repeat_loci = [(repeat_start, repeat_end - atomicity)]

    if alignment_length >= cfg.min_length(atomicity):
        repeat_length = repeat_end - repeat_start
        if repeat_length >= cfg.min_length(motif_length):
            emit("\t".join((
                sequence_id, str(repeat_start), str(repeat_end), motif,
                f"{atomicity} | {motif_length}", str(repeat_end - repeat_start),
                str((repeat_end - repeat_start) // atomicity),
                format_purity(purity), "+", f"SEED-{seed_type}", cigar_string)))

    # recursion into uncovered flanks (parse_seed.cpp:444-463)
    flank_start = seed_start
    for first, second in repeat_loci:
        if flank_start >= first:
            flank_start = second
            continue
        if first - flank_start >= cfg.min_length(motif_length):
            if flank_start < seed_start:
                flank_start = seed_start
            if first > seed_end:
                first = seed_end
            if not (flank_start == seed_start and first == seed_end):
                process_seed(flank_start, first, motif_length, seed_type,
                             sequence_id, sequence, sequence_length,
                             channel_longest_run, code, n_mask, cfg, emit)
        flank_start = second

    if seed_end - flank_start >= cfg.min_length(motif_length):
        if flank_start < seed_start:
            flank_start = seed_start
        if flank_start != seed_start:
            process_seed(flank_start, seed_end, motif_length, seed_type,
                         sequence_id, sequence, sequence_length,
                         channel_longest_run, code, n_mask, cfg, emit)


def possible_motifs(code: np.ndarray, seed_start: int,
                    seed_sequence_length: int, motif_length: int,
                    sequence_length: int, cfg: RibbitConfig
                    ) -> tuple[list[int], list[int], list[int]]:
    """possibleMotifs (parse_smallmotif_seed.cpp:76-188): per-repeat-class run
    tracking over a sliding 2m-bit window.  Returns (motifs, starts, ends)."""
    m = motif_length
    mask = (1 << (2 * m)) - 1
    seed_end = seed_start + seed_sequence_length
    if seed_end > sequence_length - 1:
        seed_end = sequence_length - 1

    motifs: list[int] = []
    starts: list[int] = []
    ends: list[int] = []

    new_motif_start: dict[int, int] = {}
    M_START: dict[int, int] = {}
    M_END: dict[int, int] = {}
    M_UNITS: dict[int, int] = {}
    M_GAPS: dict[int, int] = {}
    M_GAPSIZE: dict[int, int] = {}
    M_NEXT: dict[int, int] = {}

    min_len = cfg.min_length(m)
    perf_units = cfg.n_perfect_units(m)
    guard = 0.9 * m - 1
    window = 0

    for j in range(seed_start, seed_end):
        window = ((window << 2) | int(code[j])) & mask
        motif = bitutils.repeat_class(window, m)
        wstart = j - (m - 1)
        wend = j + 1

        if j - seed_start >= guard:
            rotated = ((window << 2) | (window >> ((m - 1) * 2))) & mask
            if motif not in new_motif_start:
                new_motif_start[motif] = wstart
                M_START[motif] = wstart
                M_END[motif] = wend
                M_UNITS[motif] = 1
                M_GAPS[motif] = 0
                M_GAPSIZE[motif] = 0
                M_NEXT[motif] = rotated
            else:
                if wstart - M_END[motif] > 3 * m:
                    if (M_END[motif] - M_START[motif] >= min_len and
                            M_UNITS[motif] >= perf_units):
                        motifs.append(motif)
                        starts.append(M_START[motif])
                        ends.append(M_END[motif])
                    M_START[motif] = wstart
                    M_END[motif] = wend
                    M_UNITS[motif] = 1
                    M_GAPS[motif] = 0
                    M_GAPSIZE[motif] = 0
                    M_NEXT[motif] = rotated
                    new_motif_start[motif] = wstart
                else:
                    if M_END[motif] < j:
                        gap = j - M_END[motif]
                        if gap < m:
                            M_GAPS[motif] += 1
                            M_GAPSIZE[motif] += 1
                        elif gap % m > 0:
                            M_GAPS[motif] += gap // m + 1
                            M_GAPSIZE[motif] += gap + 1
                        else:
                            M_GAPS[motif] += gap // m
                            M_GAPSIZE[motif] += gap
                    elif M_END[motif] == j and M_NEXT[motif] != window:
                        M_GAPS[motif] += 1
                        M_GAPSIZE[motif] += 1

                    if wstart - new_motif_start[motif] >= m:
                        new_motif_start[motif] = wstart
                        M_UNITS[motif] += 1
                    M_END[motif] = wend
                    M_NEXT[motif] = rotated

    # leftover motifs; the reference iterates an unordered_map here
    # (parse_smallmotif_seed.cpp:177-187) — order replicated in
    # umap_order.libstdcxx_order
    from .umap_order import libstdcxx_order
    for motif in libstdcxx_order(list(new_motif_start.keys())):
        if (M_END[motif] - M_START[motif] >= min_len and
                M_UNITS[motif] >= perf_units):
            motifs.append(motif)
            starts.append(M_START[motif])
            ends.append(M_END[motif])

    return motifs, starts, ends


def calculate_motif_units(code: np.ndarray, start: int, length: int,
                          motif_length: int, sequence_length: int,
                          motif_unit: int) -> int:
    """calculateMotifUnits (parse_smallmotif_seed.cpp:26-72)."""
    m = motif_length
    mask = (1 << (2 * m)) - 1
    seed_end = start + length
    if seed_end > sequence_length - 1:
        seed_end = sequence_length - 1
    window = 0
    motif_position: dict[int, int] = {}
    motif_units: dict[int, int] = {}
    guard = 0.9 * m - 1
    for j in range(start, seed_end):
        window = ((window << 2) | int(code[j])) & mask
        if j - start >= guard:
            motif = bitutils.repeat_class(window, m)
            if motif not in motif_position:
                motif_position[motif] = j - (m - 1)
                motif_units[motif] = 1
            else:
                if (j - (m - 1)) - motif_position[motif] >= m:
                    motif_position[motif] = j - (m - 1)
                    motif_units[motif] += 1
    return motif_units.get(motif_unit, 0)


def process_seed_motifwise(seed_start: int, seed_end: int, motif_length: int,
                           seed_type: int, sequence_id: str, sequence: str,
                           sequence_length: int, channel_longest_run,
                           code: np.ndarray, n_mask: np.ndarray,
                           cfg: RibbitConfig, emit: EmitFn) -> None:
    """processSeedMotifWise (parse_smallmotif_seed.cpp:190-288)."""
    seed_sequence_length = _n_trimmed_length(n_mask, seed_start, seed_end,
                                             motif_length)
    if channel_longest_run(seed_start, seed_end) < CONTINUOUS_ONES_THRESHOLD:
        return

    motifs, starts, ends = possible_motifs(code, seed_start,
                                           seed_sequence_length, motif_length,
                                           sequence_length, cfg)
    if not motifs:
        return

    for idx in range(len(motifs)):
        motif_unit = motifs[idx]
        atomicity = bitutils.atomicity(motif_unit, motif_length)
        motif = bitutils.motif_to_string(motif_unit, motif_length)[:atomicity]
        motif_unit >>= 2 * (motif_length - atomicity)
        motif_sequence = sequence[starts[idx]:ends[idx]]
        motif_sequence_length = ends[idx] - starts[idx]

        ppr_length = _ppr_length(motif_sequence_length, motif_length)
        ppr = _build_ppr(motif, ppr_length)
        alignment = align_strings(motif_sequence, ppr)
        if alignment is None or not alignment.cigar_string:
            continue
        cigar_values, cigar_string, purity = process_cigar_motifwise(
            starts[idx], motif_sequence_length, alignment.cigar_string,
            atomicity)
        repeat_start, repeat_end, _alen, _mu = cigar_values
        repeat_length = repeat_end - repeat_start
        match_units = calculate_motif_units(code, repeat_start, repeat_length,
                                            atomicity, sequence_length,
                                            motif_unit)

        if (match_units >= cfg.n_perfect_units(atomicity) and
                repeat_length >= cfg.min_length(atomicity)):
            emit("\t".join((
                sequence_id, str(repeat_start), str(repeat_end), motif,
                f"{atomicity} | {motif_length}", str(repeat_length),
                str(repeat_length // atomicity), format_purity(purity),
                "+", f"SEED-{seed_type}", cigar_string)))
