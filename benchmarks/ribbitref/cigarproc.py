"""CIGAR compression, purity, and trim search.

Literal port of process_cigar.cpp: cigarSplit (14-31), calculateTrimEdges
(34-86), processCIGARWithPruning (126-251), processCIGARMotifWise (254-336).

Purity is computed in float32 to match the C++ `float` division and the
downstream 6-significant-digit stream formatting.

The benchmark's frozen copy of the repository's cigarproc.py spec.
"""

from __future__ import annotations

import numpy as np

from .config import PURITY_THRESHOLD

# the precision of the purity arithmetic: C++ `float` in the upstream
# binary.  The benchmark's control sets a lower one.
FLOAT = np.float32


def cigar_split(cigar: str) -> tuple[list[int], list[str]]:
    clens: list[int] = []
    ctypes: list[str] = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            clens.append(int(num))
            ctypes.append(ch)
            num = ""
    return clens, ctypes


def calculate_trim_edges(purity: np.float32, ccigar_lengths: list[int],
                         alignment_length: int, motif_length: int,
                         minimum_length: dict[int, int]
                         ) -> tuple[tuple[int, int], np.float32, int]:
    """calculateTrimEdges (process_cigar.cpp:34-86).  Returns the chosen
    (left, right) trim pair plus the updated purity and alignment length
    (the reference mutates them by reference)."""
    trim_length = 0
    trim_edges = (0, 0)
    ncc = len(ccigar_lengths)

    while purity < PURITY_THRESHOLD:
        trim_length += 1
        max_purity = FLOAT(0)
        max_alength = 0

        for i in range(trim_length + 1):
            pair_match = 0
            pair_alignment = 0
            # even compressed indices are match runs (the compressed cigar
            # alternates match / non-match)
            for j in range(2 * i, (ncc - 1) - (2 * (trim_length - i)) + 1):
                if j % 2 == 0:
                    pair_match += ccigar_lengths[j]
                pair_alignment += ccigar_lengths[j]
            if pair_alignment == 0:
                # C++ float 0/0 is NaN; NaN >= threshold is false
                pair_purity = FLOAT("nan")
            else:
                pair_purity = FLOAT(pair_match) / FLOAT(pair_alignment)

            if pair_purity >= PURITY_THRESHOLD:
                if max_alength < pair_alignment:
                    max_purity = pair_purity
                    max_alength = pair_alignment
                    trim_edges = (i, trim_length - i)

        if max_purity > purity:
            purity = max_purity
            alignment_length = max_alength

        if alignment_length < minimum_length.get(motif_length, 0):
            break

    return trim_edges, purity, alignment_length


def process_cigar_with_pruning(seed_start: int, seed_sequence_length: int,
                               cigar: str, motif_length: int,
                               minimum_length: dict[int, int]
                               ) -> tuple[list[int], str, np.float32]:
    """processCIGARWithPruning (process_cigar.cpp:126-251).
    motif_length here is the ATOMICITY at the call sites (parse_seed.cpp:405).
    Returns ([repeat_start, repeat_end, alignment_length, match_units],
    cigar_string, purity(float32))."""
    clens, ctypes = cigar_split(cigar)

    repeat_start = seed_start
    repeat_end = seed_start + seed_sequence_length
    alignment_length = 0
    matches = 0
    match_units = 0
    ccigar_indices: list[int] = []
    ccigar_lengths: list[int] = []
    mismatch_continue = False
    start_soft_clip = 0
    new_cigar_parts: list[str] = []

    for cidx in range(len(clens)):
        clength = clens[cidx]
        ctype = ctypes[cidx]
        if ctype == "S":
            if cidx == 0:
                repeat_start += clength
                start_soft_clip = clength
            else:
                repeat_end -= clength
        elif ctype in ("X", "I", "D"):
            alignment_length += clength
            if mismatch_continue:
                ccigar_lengths[-1] += clength
            else:
                ccigar_lengths.append(clength)
            ccigar_indices.append(len(ccigar_lengths) - 1)
            mismatch_continue = True
            new_cigar_parts.append(f"{clength}{ctype}")
        elif ctype in ("=", "M"):
            alignment_length += clength
            matches += clength
            match_units += clength // motif_length
            ccigar_lengths.append(clength)
            ccigar_indices.append(len(ccigar_lengths) - 1)
            mismatch_continue = False
            new_cigar_parts.append(f"{clength}{ctype}")

    purity = FLOAT(FLOAT(matches) / FLOAT(alignment_length)) \
        if alignment_length else FLOAT("nan")
    new_cigar = "".join(new_cigar_parts)

    if purity < PURITY_THRESHOLD:
        trim_edges, purity, alignment_length = calculate_trim_edges(
            purity, ccigar_lengths, alignment_length, motif_length,
            minimum_length)

        new_cigar_parts = []
        matches = 0
        match_units = 0

        for i in range(len(ccigar_indices)):
            ccidx = ccigar_indices[i]
            if start_soft_clip:
                clength = clens[i + 1]
                ctype = ctypes[i + 1]
            else:
                clength = clens[i]
                ctype = ctypes[i]

            if ccidx < 2 * trim_edges[0]:
                if ctype != "D":
                    repeat_start += clength
            elif 2 * trim_edges[0] <= ccidx <= len(ccigar_lengths) - 1 - 2 * trim_edges[1]:
                new_cigar_parts.append(f"{clength}{ctype}")
                if ctype in ("M", "="):
                    matches += clength
                    match_units += clength // motif_length
            else:
                if ctype != "D":
                    repeat_end -= clength
        new_cigar = "".join(new_cigar_parts)

    return ([repeat_start, repeat_end, alignment_length, match_units],
            new_cigar, purity)


def process_cigar_motifwise(seed_start: int, seed_sequence_length: int,
                            cigar: str, motif_length: int
                            ) -> tuple[list[int], str, np.float32]:
    """processCIGARMotifWise (process_cigar.cpp:254-336): purity only, no trim."""
    clens, ctypes = cigar_split(cigar)

    repeat_start = seed_start
    repeat_end = seed_start + seed_sequence_length
    alignment_length = 0
    matches = 0
    match_units = 0
    new_cigar_parts: list[str] = []
    mismatch_continue = False

    for cidx in range(len(clens)):
        clength = clens[cidx]
        ctype = ctypes[cidx]
        if ctype == "S":
            if cidx == 0:
                repeat_start += clength
            else:
                repeat_end -= clength
        elif ctype in ("X", "I", "D"):
            alignment_length += clength
            mismatch_continue = True
            new_cigar_parts.append(f"{clength}{ctype}")
        elif ctype in ("=", "M"):
            alignment_length += clength
            matches += clength
            match_units += clength // motif_length
            mismatch_continue = False
            new_cigar_parts.append(f"{clength}{ctype}")

    purity = FLOAT(FLOAT(matches) / FLOAT(alignment_length)) \
        if alignment_length else FLOAT("nan")
    return ([repeat_start, repeat_end, alignment_length, match_units],
            "".join(new_cigar_parts), purity)
