"""Host (numpy) backend for the shift-XOR scan.

Produces, for every shift channel, the structures the seed scanners consume:
  - match bitmaps  eq[i][p] = (seq[p] == seq[p+shift_i])   (fasta_utils.cpp:120-122)
  - anchor bitmaps (runs of matches with length in [anchor_size, 2*shift))
    (parse_anchored_shiftxor.cpp:20-56)
  - the anchored overlay: per motif m, raw[m] | anchors[m±1, m±2]
    (fasta_utils.cpp:145-161)
  - qualified-window masks for the substitution/anchored scans
    (parse_substitute_shiftxor.cpp:460-475)

Coordinate conventions: position p == base index (the reference's reversed bit
order is absorbed here).  Tail rule: for p + shift >= L the reference compares
against shifted-in zero bits, so eq[p] = (code[p] == 0) there; N bases also
encode as 0 in the bit-planes.

This is the semantics-reference implementation; the port's CUDA kernels
(scan_events.py) compute the same bitmaps on the device.

The benchmark's frozen copy of the repository's scan_host.py spec.
"""

from __future__ import annotations

import numpy as np

from .config import RibbitConfig, ANCHOR_SIZE, WINDOW_LENGTH


def match_bitmaps(code: np.ndarray, cfg: RibbitConfig) -> np.ndarray:
    """bool[NSHIFTS, L]: eq[c, p] = (code[p] == code[p+shift_c]), with the
    zero-fill tail rule.  code must already map N -> 0."""
    L = code.shape[0]
    out = np.empty((cfg.nshifts, L), dtype=bool)
    for c in range(cfg.nshifts):
        shift = cfg.min_shift + c
        if shift >= L:
            out[c] = code == 0
            continue
        out[c, :L - shift] = code[:L - shift] == code[shift:]
        out[c, L - shift:] = code[L - shift:] == 0
    return out


def _runs(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Maximal runs of True in a 1-D bool array -> (starts, ends) half-open."""
    padded = np.empty(bits.shape[0] + 2, dtype=np.int8)
    padded[0] = padded[-1] = 0
    padded[1:-1] = bits
    d = np.diff(padded)
    return np.flatnonzero(d == 1), np.flatnonzero(d == -1)


def anchor_bitmaps(eq: np.ndarray, cfg: RibbitConfig) -> np.ndarray:
    """bool[NSHIFTS, L]: positions inside match runs of length in
    [ANCHOR_SIZE, 2*shift), considering only positions [0, L-1-shift] and only
    runs that close at a real 0 within that range (runs still open at the end
    of the range are dropped) — parse_anchored_shiftxor.cpp:34-55."""
    nshifts, L = eq.shape
    out = np.zeros_like(eq)
    for c in range(nshifts):
        shift = cfg.min_shift + c
        hi = L - shift          # exclusive bound of scanned positions [0, L-1-shift]
        if hi <= 0:
            continue
        sub = eq[c, :hi]
        starts, ends = _runs(sub)
        if starts.size == 0:
            continue
        # a run must end before the last scanned position (a closing 0 at
        # position end <= L-1-shift); ends == hi means the run hit the scan
        # boundary unclosed and is dropped
        keep = ends < hi
        lens = ends - starts
        keep &= (lens >= ANCHOR_SIZE) & (lens < 2 * shift)
        for s, e in zip(starts[keep], ends[keep]):
            out[c, s:e] = True
    return out


def overlay_bitmaps(eq: np.ndarray, anchors: np.ndarray, cfg: RibbitConfig) -> np.ndarray:
    """Per-motif anchored overlay (fasta_utils.cpp:145-161).

    Returns bool[NSHIFTS, L].  Channels whose shift is a motif length in
    [min_motif, max_motif] become raw | anchors of neighbor shifts; other
    channels (the +-2 padding shifts) keep the raw bitmap, mirroring the
    in-place overwrite in the reference."""
    out = eq.copy()
    for m in range(cfg.min_motif, cfg.max_motif + 1):
        acc = eq[cfg.motif_channel(m)].copy()
        lo = m - 2 if m > 2 else 1
        for i in range(lo, m + 3):
            if i == m:
                continue
            acc |= anchors[i - cfg.min_shift]
        out[cfg.motif_channel(m)] = acc
    return out


def window_qualified(bits: np.ndarray, n_mask: np.ndarray, threshold: int) -> np.ndarray:
    """For each channel and window start w in [0, L-WINDOW_LENGTH]:
    +1 qualified (window N-free, popcount >= threshold)
     0 evaluated but below threshold (window N-free, popcount < threshold)
    -1 not evaluated (window overlaps an N — the scanner skips it entirely,
       parse_substitute_shiftxor.cpp:433-469)

    Returns int8[NSHIFTS, L-WINDOW_LENGTH+1] (empty second dim if L < 8)."""
    nshifts, L = bits.shape
    W = WINDOW_LENGTH
    nw = L - W + 1
    if nw <= 0:
        return np.zeros((nshifts, 0), dtype=np.int8)
    # sliding popcount via cumulative sums
    cs = np.cumsum(bits, axis=1, dtype=np.int32)
    win = cs[:, W - 1:].copy()
    win[:, 1:] -= cs[:, :nw - 1]
    ncs = np.cumsum(n_mask, dtype=np.int32)
    nwin = ncs[W - 1:].copy()
    nwin[1:] -= ncs[:nw - 1]
    evaluated = nwin == 0
    out = np.where(win >= threshold, np.int8(1), np.int8(0))
    out[:, ~evaluated] = -1
    return out


def perfect_runs(eq_channel: np.ndarray, n_mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Runs of 1s for the perfect scanner: N positions terminate runs
    (the reference checks N before the bit, parse_perfect_shiftxor.cpp:175)."""
    return _runs(eq_channel & ~n_mask)
