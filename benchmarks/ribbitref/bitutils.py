"""Motif bit utilities: canonical repeat classes, atomicity, motif decoding.

Motifs are 2-bit-per-base integers (A=00,C=01,G=10,T=11), most significant
pair = first base — matching the reference's window encoding
(bitseq_utils.cpp:14-221).  Python ints subsume the reference's
uint32/uint256 split.

The benchmark's frozen copy of the repository's bitutils.py spec.
"""

from __future__ import annotations

from functools import lru_cache


def motif_to_string(motif: int, motif_length: int) -> str:
    """calculateMotif (bitseq_utils.cpp:14-38)."""
    out = []
    for i in range(motif_length):
        val = (motif >> (2 * (motif_length - 1 - i))) & 3
        out.append("ACGT"[val])
    return "".join(out)


@lru_cache(maxsize=1 << 20)
def repeat_class(motif: int, motif_length: int) -> int:
    """calculateRepeatClass: lexicographically smallest 2-bit cyclic rotation
    (bitseq_utils.cpp:185-221)."""
    mask = (1 << (2 * motif_length)) - 1
    best = motif
    cycle = motif
    for i in range(motif_length - 1):
        cycle = ((motif >> (2 * (motif_length - (i + 1)))) |
                 (motif << (2 * (i + 1)))) & mask
        if cycle < best:
            best = cycle
    return best


@lru_cache(maxsize=1 << 20)
def atomicity(motif: int, motif_length: int) -> int:
    """calculateAtomicity: smallest period f dividing motif_length with
    motif >> 2f == motif & mask(2*(m-f)) (bitseq_utils.cpp:88-114)."""
    for f in range(1, motif_length // 2 + 1):
        if motif_length % f != 0:
            continue
        mask = (1 << (2 * (motif_length - f))) - 1
        if (motif >> (2 * f)) == (motif & mask):
            return f
    return motif_length


@lru_cache(maxsize=1 << 18)
def atomicity_long(motif: int, motif_length: int) -> int:
    """calculateAtomicityLongMotif: scans every f < m - m/3 without the
    divisibility requirement (bitseq_utils.cpp:116-137)."""
    for f in range(1, motif_length - motif_length // 3):
        mask = (1 << (2 * (motif_length - f))) - 1
        if (motif >> (2 * f)) == (motif & mask):
            return f
    return motif_length
