"""The least time of the extraction work: a frozen copy of the counts in
ribbit_tpu_torch/bench_roofline.py (scan_work, HBM_BYTES_PER_S,
ISSUE_LANES_PER_SM), so that the yardstick does not move with the program.

An extractor call over L bp (its segment and halos) needs at least the
anchor pass (read the code, write one int32 word per 32 positions and
shift row; one compare per position and shift row) and the event pass
(read code, N mask and those words; write 4 B per position and 8 plane
rows; compare, overlay OR and two 8-window sums per position and plane
row).  Its floor is the larger of bytes over the H100's 3.35 TB/s and
int32 operations over the issue limit, 132 SMs x 128 lanes x 1.98 GHz.
The floors count the work, whatever kernels do it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
OUT_ROWS = 8


def nsp_of(min_shift: int, max_shift: int) -> int:
    ns = max_shift - min_shift + 1
    return max(32, ((ns + 7) // 8) * 8)


def extract_work(L: int, min_shift: int, max_shift: int) -> list:
    """[(bytes, int32 operations)] of the anchor and the event pass."""
    nshifts = max_shift - min_shift + 1
    nsp = nsp_of(min_shift, max_shift)
    anchors = nshifts * ((L + 31) // 32) * 4
    return [(L + anchors, 1 * nshifts * L),
            (2 * L + anchors + 4 * L * (nsp // OUT_ROWS), 4 * nsp * L)]


def extract_floor_s(L: int, min_shift: int, max_shift: int) -> float:
    return sum(max(b / HBM_BYTES_PER_S, o / INT32_OPS_PER_S)
               for b, o in extract_work(L, min_shift, max_shift))
