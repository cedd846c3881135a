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

The port's copy of ribbit_tpu/refine.py, which it may not import.
process_seed and process_seed_motifwise are the Python engine's
refinement; refine_batched uses the helpers.  mostFrequentLongerMotif
runs in the C core only (csrc/ribbit_vote.c), which raises if it does not
build: the numpy voting and its scalar cross-check are not copied.
"""

from __future__ import annotations

import ctypes
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
    """mostFrequentLongerMotif (parse_seed.cpp:153-256) in the C core
    (ribbit_vote_longer): greedy diagonal voting with ±2 bp jitter per
    unit; returns the motif unit at the winning row start."""
    from .native import get_vote_lib
    mm = get_vote_lib().ribbit_vote_longer(
        code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_mask.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        code.shape[0], seed_start, seed_sequence_length, motif_length)
    unit = 0
    for c in code[mm:mm + motif_length].tolist():
        unit = (unit << 2) | int(c)
    # QUIRK: the reference packs the motif into a uint256_t
    # (parse_seed.cpp:246-253), so for motif_length > 128 the leading
    # 2*(m-128) bits overflow away and those bases read back as 'A'
    return unit & ((1 << 256) - 1)


def _most_frequent_longer_motif_scalar(code: np.ndarray, n_mask: np.ndarray,
                                       seed_start: int, seed_sequence_length: int,
                                       motif_length: int, sequence_length: int) -> int:
    """Direct scalar port of mostFrequentLongerMotif (parse_seed.cpp:153-256);
    kept as the cross-check oracle for the C voter above and vote_device
    (a copy of the JAX package's; no route calls it)."""
    seed_end = seed_start + seed_sequence_length
    m = motif_length

    def match(row: int, col: int) -> bool:
        return (not n_mask[col]) and code[row] == code[col]

    mmotif_index = 0
    max_count = 0

    for row_start in range(seed_start, seed_end - m + 1):
        row_count = 0

        dstream = row_start + m
        while dstream < seed_end:
            max_dindex, max_dcount = -2, 0
            for x in range(-2, 3):
                dcount = 0
                for i in range(m):
                    if dstream + x + i >= seed_end:
                        break
                    if match(row_start + i, dstream + x + i):
                        dcount += 1
                if dcount > max_dcount:
                    max_dcount = dcount
                    max_dindex = x
            row_count += max_dcount
            dstream += max_dindex + m

        ustream = row_start - m
        while ustream > seed_start:
            max_dindex, max_dcount = -2, 0
            for x in range(-2, 3):
                dcount = 0
                for i in range(m):
                    if ustream + x + i < 0:
                        break
                    if match(row_start + i, ustream + x + i):
                        dcount += 1
                if dcount > max_dcount:
                    max_dcount = dcount
                    max_dindex = x
            row_count += max_dcount
            ustream += max_dindex - m

        if ustream < seed_start and abs(ustream - seed_start) < m:
            initial_lastrow = row_start + m - 1
            pcindex = seed_start + ((m + (ustream - seed_start)) - 1)
            prefix_rows = m + (ustream - seed_start)
            max_dindex, max_dcount = -2, 0
            for x in range(-2, 3):
                dcount = 0
                for i in range(prefix_rows):
                    if pcindex + x - i >= seed_end or pcindex + x - i < seed_start:
                        break
                    if match(initial_lastrow - i, pcindex + x - i):
                        dcount += 1
                if dcount > max_dcount:
                    max_dcount = dcount
                    max_dindex = x
            row_count += max_dcount

        if row_count > max_count:
            max_count = row_count
            mmotif_index = row_start

    motif_unit = 0
    for j in range(mmotif_index, mmotif_index + m):
        motif_unit = (motif_unit << 2) | int(code[j])
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
