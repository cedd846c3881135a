"""The three event streams of one whole sequence, in plain torch: the
contract that the port's device extractor meets segment by segment and
stitches (perfect runs, threshold-7 window runs, threshold-6 overlay runs;
channel-major, position-sorted, half-open).

For motif length m (shift s = m) and position p:

  eq[s][p]      code[p] == code[p+s], code reading 0 past the end
                (fasta_utils.cpp:120-122; N encodes as 0)
  anchors[s]    maximal runs of eq[s] over [0, L-s) of length in
                [ANCHOR_SIZE, 2s) that close before L-s
                (parse_anchored_shiftxor.cpp:20-56)
  overlay[m]    eq[m] | anchors[m-2 .. m+2] (fasta_utils.cpp:145-161)
  q7 / q6       the window [p, p+8) holds no N (past the end reads N) and
                at least 7 of eq / 6 of overlay
  perfect       runs of eq & ~N of length >= 12-m for m <= 6, else m
                (parse_perfect_shiftxor.cpp:146-226)

The whole sequence is one piece: no segments, no halos, no stitching.
One shift row at a time, so device memory stays a few bytes a bp.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ANCHOR_SIZE, WINDOW_LENGTH, RibbitConfig


def _shift_eq(code: torch.Tensor, s: int) -> torch.Tensor:
    L = code.shape[0]
    shifted = torch.zeros_like(code)
    if s < L:
        shifted[:L - s] = code[s:]
    return code == shifted


def _runs(bits: torch.Tensor):
    """(starts, ends) of the maximal runs of a bool [L] tensor."""
    x = torch.zeros(bits.shape[0] + 2, dtype=torch.int8, device=bits.device)
    x[1:-1] = bits
    d = x[1:] - x[:-1]
    return (torch.nonzero(d == 1).flatten(),
            torch.nonzero(d == -1).flatten())


def _anchor_row(code: torch.Tensor, s: int) -> torch.Tensor:
    L = code.shape[0]
    hi = L - s
    b = _shift_eq(code, s)
    if hi <= 0:
        return torch.zeros_like(b)
    b[max(hi, 0):] = False
    starts, ends = _runs(b)
    lens = ends - starts
    keep = (ends < hi) & (lens >= ANCHOR_SIZE) & (lens < 2 * s)
    delta = torch.zeros(L + 1, dtype=torch.int32, device=code.device)
    delta[starts[keep]] = 1
    delta[ends[keep]] = -1
    return delta.cumsum(0)[:L] > 0


def _win8(x: torch.Tensor) -> torch.Tensor:
    L = x.shape[0]
    xp = torch.cat([x.to(torch.int8),
                    torch.zeros(WINDOW_LENGTH - 1, dtype=torch.int8,
                                device=x.device)])
    return sum(xp[k:k + L] for k in range(WINDOW_LENGTH))


def event_streams(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig,
                  device="cpu"):
    """(perfect, q7, q6), each (starts, ends, offsets) of int64 numpy
    arrays, offsets[c]..offsets[c+1] the events of motif m = min_motif + c."""
    dev = torch.device(device)
    c = torch.from_numpy(np.ascontiguousarray(code).view(np.uint8)).to(dev)
    nm = torch.from_numpy(np.ascontiguousarray(n_mask).view(np.uint8)).to(
        dev).bool()
    L = c.shape[0]
    nfree = _win8(torch.cat([nm, torch.ones(WINDOW_LENGTH - 1,
                                            dtype=torch.bool, device=dev)])
                  )[:L] == 0
    anchors: dict = {}

    def anch(s: int) -> torch.Tensor:
        if s not in anchors:
            anchors[s] = _anchor_row(c, s)
        return anchors[s]

    out = [([], [], [0]) for _ in range(3)]
    for m in range(cfg.min_motif, cfg.max_motif + 1):
        eq = _shift_eq(c, m)
        ov = eq.clone()
        for s in range(max(m - 2, cfg.min_shift), m + 3):
            if s != m and s <= cfg.max_shift:
                ov |= anch(s)
        for s in [k for k in anchors if k < m - 1]:
            del anchors[s]
        cutoff = 12 - m if m <= 6 else m
        ps, pe = _runs(eq & ~nm)
        keep = (pe - ps) >= cutoff
        rows = ((ps[keep], pe[keep]),
                _runs((_win8(eq) >= 7) & nfree),
                _runs((_win8(ov) >= 6) & nfree))
        for k, (s_, e_) in enumerate(rows):
            out[k][0].append(s_.cpu().numpy().astype(np.int64))
            out[k][1].append(e_.cpu().numpy().astype(np.int64))
            out[k][2].append(out[k][2][-1] + s_.shape[0])
    return tuple((np.concatenate(s), np.concatenate(e),
                  np.asarray(off, dtype=np.int64)) for s, e, off in out)
