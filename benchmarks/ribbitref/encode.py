"""Sequence encoding.

The reference packs bases into two bit-planes with A=00, C=01, G=10, T=11 and
marks anything else as N (fasta_utils.cpp:90-115).  In the bit-planes an N
behaves like 'A' (both plane bits stay 0) — the N mask is tracked separately.
We keep sequence-position order (index s == base s); the reference's reversed
bit order (fasta_utils.cpp:93) is an implementation detail that all coordinate
logic here absorbs.

The benchmark's frozen copy of the repository's encode.py spec.
"""

from __future__ import annotations

import numpy as np

_CODE_LUT = np.zeros(256, dtype=np.int8)          # everything defaults to 0 (A/N)
_N_LUT = np.ones(256, dtype=bool)                 # everything defaults to N
for _chars, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
    for _c in _chars:
        _CODE_LUT[ord(_c)] = _code
        _N_LUT[ord(_c)] = False


def encode(sequence: str) -> tuple[np.ndarray, np.ndarray]:
    """Encode a sequence string.

    Returns (code, n_mask):
      code   int8[L]  2-bit base code, 0 for N (mirrors the zero bit-planes)
      n_mask bool[L]  True where the base is not ACGT (fasta_utils.cpp:111-113)
    """
    # latin-1 keeps arbitrary bytes 1:1; anything not ACGT maps to N,
    # matching the reference switch default (fasta_utils.cpp:111-113)
    raw = np.frombuffer(sequence.encode("latin-1"), dtype=np.uint8)
    return _CODE_LUT[raw], _N_LUT[raw]


_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode(code: np.ndarray, n_mask: np.ndarray | None = None) -> str:
    out = _DECODE[code]
    if n_mask is not None:
        out = np.where(n_mask, np.uint8(ord("N")), out)
    return out.tobytes().decode("ascii")
