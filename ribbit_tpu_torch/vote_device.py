"""Device-batched diagonal voting for large-motif inference.

The port of ribbit_tpu/vote_device.py: a brute-force device formulation of
mostFrequentLongerMotif (parse_seed.cpp:153-256; scalar spec:
refine._most_frequent_longer_motif_scalar; production voter: the C core's
ribbit_vote_longer, csrc/ribbit_vote.c).  Refinement does not call it:
it keeps the C voter (refine.most_frequent_longer_motif).

  1. Every match count a walk could query is one dense table per run,
     C[row, cursor] = sum_{i<m} eq(code[row+i], code[cursor+i])
     & !n[cursor+i] & [cursor+i < seed_end], as a one-hot product
     [R, 4m] x [B, 4m]^T (torch.bmm).  The b-side one-hots absorb the
     n-mask and the spec's clamps (parse_seed.cpp:163-202), as in the JAX
     package.
  2. Per-direction best-jitter tables BestC/BestX[row, w] = strict max over
     x in -2..2 of C[row, w + x] (the scan order keeps the first maximum,
     the upstream gate folded in), so a greedy step is one lookup.
  3. The walks run for all candidate rows at once; a lookup is a gather.
  4. The partial-prefix vote (parse_seed.cpp:205-233, the C core's
     ribbit_vote_prefix_batch) and the first-strictly-highest-row rule run
     on the host from the returned (count, final upstream cursor) pairs.

Where it departs from the JAX package (results are the spec's in both
where the JAX package is exact; ROADMAP §3):
  - the one-hots multiply in float16: every product and partial sum is an
    integer <= m_pad <= 512, exact to 2,048 (bfloat16, whose torch
    product is bfloat16 too, would round odd counts above 256);
  - the count and best-count tables are int16, so counts stay exact for
    every m up to -M 300 (the JAX banded tables are int8 and wrap above
    m = 127);
  - the walks are Python loops that synchronise on act.any() each step
    (vote_longer_batch.steps counts them), and each bucket's last batch
    holds the runs that remain, not repeats of run 0;
  - _host_index is the C voter alone (the port's C core always builds).

The JAX package measured its form on a TPU and found it exact but 20-50x
slower than the host voter (its module docstring); chip_smoke.py phase 13
measures this one against the C voter on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .backend import require_cuda
from .native import get_vote_lib

IMPLS = ("banded", "spec")
TABLE_BYTES = 2                # int16 count and best-count tables


def _pow2_at_least(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p <<= 1
    return p


def bucket_of(ssl: int, m: int) -> Tuple[int, int]:
    """(ssl_pad, m_pad) bucket for one run."""
    return _pow2_at_least(ssl, 128), _pow2_at_least(m, 16)


def batch_size_of(ssl_pad: int, bytes_cap: int = 384 << 20) -> int:
    """Runs per device batch, bounded by the sheared tables' footprint
    (~3 int16 tables of [R_pad, 2*R_pad+code])."""
    per_run = ssl_pad * (2 * ssl_pad + 16) * 3 * TABLE_BYTES
    return max(1, min(64, bytes_cap // max(per_run, 1)))


def _pack_bucket(code: np.ndarray, n_mask: np.ndarray,
                 runs: Sequence[Tuple[int, int, int]],
                 ssl_pad: int, m_pad: int):
    """Stack one bucket's runs into padded window arrays: codew[n, 0] is
    position seed_start - 2 of run n; positions off the contig carry code
    4 (no base) with the n-mask set.  The width ssl_pad + m_pad + 8 holds
    every slice _count_table takes."""
    L = code.shape[0]
    N = len(runs)
    W = ssl_pad + m_pad + 8
    codew = np.full((N, W), 4, dtype=np.int8)
    nmaskw = np.ones((N, W), dtype=bool)
    for j, (ss, ssl, m) in enumerate(runs):
        lo = ss - 2
        hi = min(ss + ssl + m + 2, L)
        src_lo = max(lo, 0)
        dst = src_lo - lo
        codew[j, dst:dst + hi - src_lo] = code[src_lo:hi]
        nmaskw[j, dst:dst + hi - src_lo] = n_mask[src_lo:hi]
    m_n = np.asarray([r[2] for r in runs], dtype=np.int32)
    ssl_n = np.asarray([r[1] for r in runs], dtype=np.int32)
    ss_n = np.asarray([r[0] for r in runs], dtype=np.int32)
    return codew, nmaskw, m_n, ssl_n, ss_n


def _prefix_counts(code: np.ndarray, n_mask: np.ndarray, seed_start: int,
                   ssl: int, m: int, ustream: np.ndarray) -> np.ndarray:
    """Partial-prefix votes (parse_seed.cpp:205-233) for all rows through
    the C core; `ustream` is each row's final upstream cursor."""
    R = ustream.shape[0]
    out = np.zeros(R, dtype=np.int32)
    us = np.ascontiguousarray(ustream, dtype=np.int32)
    get_vote_lib().ribbit_vote_prefix_batch(
        code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_mask.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        code.shape[0], seed_start, ssl, m,
        us.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), R,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out.astype(np.int64)


def _prefix_counts_np(code: np.ndarray, n_mask: np.ndarray, seed_start: int,
                      ssl: int, m: int, ustream: np.ndarray) -> np.ndarray:
    """_prefix_counts in numpy, the plain reference the tests hold it to.
    Counting is order-independent, so the spec's reversed windows (rows and
    columns decreasing with i) are summed as forward ranges."""
    L = code.shape[0]
    seed_end = seed_start + ssl
    R = ustream.shape[0]
    out = np.zeros(R, dtype=np.int64)
    for r in range(R):
        us = int(ustream[r])
        if not (us < seed_start and seed_start - us < m):
            continue
        lastrow = seed_start + r + m - 1
        prefix_rows = m + (us - seed_start)
        best = 0
        for x in (-2, -1, 0, 1, 2):
            pc = us + m - 1 + x
            if pc >= seed_end or pc >= L or lastrow >= L:
                continue
            lim = min(prefix_rows, pc - seed_start + 1)
            if lim <= 0:
                continue
            a = code[lastrow - lim + 1:lastrow + 1]
            b = code[pc - lim + 1:pc + 1]
            nn = n_mask[pc - lim + 1:pc + 1]
            dc = int(((a == b) & ~nn).sum())
            if dc > best:
                best = dc
        out[r] = best
    return out


def _host_index(code: np.ndarray, n_mask: np.ndarray,
                ss: int, ssl: int, m: int) -> int:
    """Exact host winner (the band-overflow re-vote): the C voter."""
    return int(get_vote_lib().ribbit_vote_longer(
        code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_mask.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        code.shape[0], ss, ssl, m))


def _count_table(codew, nmaskw, m_n, ssl_n, *, m_pad, R_pad, B_pad):
    """The dense count table C[n, r, b] (int16) as a one-hot product."""
    N = codew.shape[0]
    dev = codew.device
    # win[n, s, i] = codew[n, s + i]: the a side starts at window 2, the b
    # side at 0; torch clips a slice past the end, so check the widths
    win = codew.unfold(1, m_pad, 1)
    A = win[:, 2:2 + R_pad]                           # [N, R, m_pad]
    B = win[:, :B_pad]                                # [N, B, m_pad]
    NM = nmaskw.unfold(1, m_pad, 1)[:, :B_pad]
    if A.shape[1] != R_pad or B.shape[1] != B_pad:
        raise ValueError(f"windows of {codew.shape[1]} are too narrow for "
                         f"R_pad {R_pad}, B_pad {B_pad}, m_pad {m_pad}")
    i_iota = torch.arange(m_pad, device=dev)
    base = torch.arange(4, dtype=codew.dtype, device=dev)
    m_b = m_n.long()[:, None, None]
    # a side: zero i >= m (the contraction runs to m, not m_pad); the L
    # clamp rides the sentinel (code 4 one-hots to zero)
    a_valid = i_iota < m_b                            # [N, 1, m_pad]
    Aoh = (A[..., None] == base) & a_valid[..., None]
    # b side: n-mask and position < seed_end (window index w+i < ssl+2)
    w_iota = torch.arange(B_pad, device=dev)
    b_valid = (~NM & ((w_iota[:, None] + i_iota)
                      < (ssl_n.long()[:, None, None] + 2)) & a_valid)
    Boh = (B[..., None] == base) & b_valid[..., None]
    Af = Aoh.reshape(N, R_pad, 4 * m_pad).to(torch.float16)
    Bf = Boh.reshape(N, B_pad, 4 * m_pad).to(torch.float16)
    return torch.bmm(Af, Bf.transpose(1, 2)).to(torch.int16)


def _best_tables(T, pos=None, lo=None):
    """(BestC int16, BestX int8) over the last axis: the strict maximum of
    T[..., k + x] over x = -2..2 in that order, from count 0 and jitter -2
    (parse_seed.cpp:169/190), so ties and all-zero columns keep the first.
    With `pos` (the cursor at each column) a shifted count counts only
    where pos + x >= lo, the upstream gate."""
    bc = torch.zeros_like(T)
    bx = torch.full(T.shape, -2, dtype=torch.int8, device=T.device)
    for x in range(-2, 3):
        if x < 0:
            tx = F.pad(T[..., :x], (-x, 0))
        elif x > 0:
            tx = F.pad(T[..., x:], (0, x))
        else:
            tx = T
        if pos is not None:
            tx = torch.where(pos + x >= lo, tx, 0)
        upd = tx > bc
        bc = torch.where(upd, tx, bc)
        bx = bx.masked_fill(upd, x)
    return bc, bx


def _lookup(bc, bx, idx):
    """(count, jitter) at column idx[n, r] of row r's tables."""
    idx = idx[..., None]
    return bc.gather(2, idx)[..., 0], bx.gather(2, idx)[..., 0]


def _still_active(act, w, ssl_r, step_sign):
    """Downstream walks run while the cursor is below seed_end, upstream
    ones while it is past seed_start (window indices, seed_start = 2)."""
    return act & ((w < ssl_r + 2) if step_sign > 0 else (w > 2))


def _vote_bucket_spec(codew, nmaskw, m_n, ssl_n, ss_n, *, m_pad, R_pad,
                      B_pad):
    """Reference bucket kernel: the full-width walk over the unsheared
    table.  Returns (row totals [N, R_pad] int32, final upstream cursors
    [N, R_pad] as window indices, overflow flags [N] (all False), walk
    steps)."""
    N = codew.shape[0]
    dev = codew.device
    C = _count_table(codew, nmaskw, m_n, ssl_n,
                     m_pad=m_pad, R_pad=R_pad, B_pad=B_pad)
    w_iota = torch.arange(B_pad, device=dev)
    bc_dn, bx_dn = _best_tables(C)
    # upstream gate: absolute cursor >= 0  <=>  w + x >= 2 - seed_start
    bc_up, bx_up = _best_tables(C, w_iota, 2 - ss_n.long()[:, None, None])

    r_iota = torch.arange(R_pad, device=dev)[None, :]
    m_r = m_n.long()[:, None]
    ssl_r = ssl_n.long()[:, None]
    R_r = ssl_r - m_r + 1

    def walk(bc_t, bx_t, w, act, step_sign):
        rc = torch.zeros((N, R_pad), dtype=torch.int32, device=dev)
        steps = 0
        while bool(act.any()):
            # an active row's cursor lies in [0, B_pad); an inactive one's
            # may not, so clamp it (its lookup is masked out below)
            c, x = _lookup(bc_t, bx_t, w.clamp(0, B_pad - 1))
            rc += torch.where(act, c, 0)
            w = w + torch.where(act, x + step_sign * m_r, 0)
            act = _still_active(act, w, ssl_r, step_sign)
            steps += 1
        return rc, w, steps

    # downstream: first cursor row+m, active while cursor < seed_end
    w0_dn = (r_iota + m_r + 2).expand(N, R_pad)
    rc_dn, _, s_dn = walk(bc_dn, bx_dn, w0_dn, r_iota < R_r - 1, +1)
    # upstream: first cursor row-m, active while cursor > seed_start
    w0_up = (r_iota - m_r + 2).expand(N, R_pad)
    rc_up, w_up, s_up = walk(bc_up, bx_up, w0_up,
                             (w0_up > 2) & (r_iota < R_r), -1)
    return (rc_dn + rc_up, w_up,
            torch.zeros(N, dtype=torch.bool, device=dev), s_dn + s_up)


def _vote_bucket(codew, nmaskw, m_n, ssl_n, ss_n, *, m_pad, R_pad, B_pad,
                 w_band=128):
    """Production bucket kernel: sheared lag-space tables and a banded
    walk, as _vote_bucket_spec returns.

    In lag space (j = cursor - row) every row starts its walk at the same
    column and each step moves a row's lag by at most +-2, so the rows'
    lags stay clustered: each step reads a band of w_band columns that
    starts at the least active lag.  A run whose active lags ever spread
    past the band raises its overflow flag; vote_longer_batch re-votes it
    on the C voter.
    """
    N = codew.shape[0]
    dev = codew.device
    C = _count_table(codew, nmaskw, m_n, ssl_n,
                     m_pad=m_pad, R_pad=R_pad, B_pad=B_pad)

    # shear: T[n, r, j] = C[n, r, r + j - LAM0] (0 off the table), by the
    # pad-flatten-reshape diagonal trick
    LAM0 = R_pad + 2
    Wd = LAM0 + B_pad
    D = Wd + 1
    if not 0 < w_band <= D:
        raise ValueError(f"w_band {w_band} outside (0, {D}]")
    Cp = F.pad(C, (LAM0, 0))
    T = F.pad(Cp.reshape(N, R_pad * Wd), (0, R_pad)).reshape(N, R_pad, D)
    del C, Cp

    r_iota = torch.arange(R_pad, device=dev)[None, :]
    j_row = torch.arange(D, device=dev)
    bc_dn, bx_dn = _best_tables(T)
    # upstream gate: absolute cursor >= 0  <=>  r + (j - LAM0) + x >= 2 - ss
    bc_up, bx_up = _best_tables(T, r_iota[..., None] + j_row - LAM0,
                                2 - ss_n.long()[:, None, None])
    del T

    m_r = m_n.long()[:, None]
    ssl_r = ssl_n.long()[:, None]
    R_r = ssl_r - m_r + 1
    big = 1 << 30

    def walk(bc_t, bx_t, j, act, step_sign):
        rc = torch.zeros((N, R_pad), dtype=torch.int32, device=dev)
        ovf = torch.zeros(N, dtype=torch.bool, device=dev)
        steps = 0
        while bool(act.any()):
            start = torch.where(act, j, big).amin(1).clamp(0, D - w_band)
            lo = start[:, None]
            hi = lo + (w_band - 1)
            ovf |= (act & ((j < lo) | (j > hi))).any(1)
            # the band's element at the clipped offset, as the JAX band
            # slice's one-hot reads it (only an overflowed run's rows
            # are clipped, and the run re-votes on the host)
            c, x = _lookup(bc_t, bx_t, torch.minimum(torch.maximum(j, lo),
                                                     hi))
            rc += torch.where(act, c, 0)
            j = j + torch.where(act, x + step_sign * m_r, 0)
            act = _still_active(act, r_iota + j - LAM0, ssl_r, step_sign)
            steps += 1
        return rc, j, ovf, steps

    # downstream: first cursor row+m (lag m+2+LAM0 for every row)
    j0_dn = (m_r + (LAM0 + 2)).expand(N, R_pad)
    rc_dn, _, ovf_dn, s_dn = walk(bc_dn, bx_dn, j0_dn, r_iota < R_r - 1, +1)
    # upstream: first cursor row-m
    j0_up = ((LAM0 + 2) - m_r).expand(N, R_pad)
    rc_up, j_up, ovf_up, s_up = walk(bc_up, bx_up, j0_up,
                                     (r_iota > m_r) & (r_iota < R_r), -1)
    return (rc_dn + rc_up, r_iota + j_up - LAM0, ovf_dn | ovf_up,
            s_dn + s_up)


def vote_longer_batch(code: np.ndarray, n_mask: np.ndarray,
                      runs: Sequence[Tuple[int, int, int]],
                      impl: str = "banded", w_band: int = 128,
                      device="cuda") -> List[int]:
    """Winning mmotif_index for each (seed_start, ssl, m) run.

    Semantics are exactly mostFrequentLongerMotif's: the device computes
    every row's downstream+upstream greedy vote totals, the host adds the
    partial-prefix vote and applies the first-strictly-highest-row rule
    (all-zero totals leave the index at 0, parse_seed.cpp:238-244).
    Runs whose banded walk overflows w_band re-vote on the C voter (exact;
    vote_longer_batch.overflows counts them).  Runs on `device`, a CUDA
    device unless the caller names the CPU.
    """
    require_cuda(device)
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    code = np.ascontiguousarray(code, dtype=np.int8)
    n_mask = np.ascontiguousarray(n_mask, dtype=bool)
    out = [0] * len(runs)
    buckets: dict = {}
    for idx, (ss, ssl, m) in enumerate(runs):
        if ssl - m + 1 <= 0:
            continue                       # no candidate rows: index 0
        buckets.setdefault(bucket_of(ssl, m), []).append(idx)

    for (ssl_pad, m_pad), idxs in sorted(buckets.items()):
        kw = dict(m_pad=m_pad, R_pad=ssl_pad, B_pad=ssl_pad + 8)
        if impl == "banded":
            kern = _vote_bucket
            kw["w_band"] = w_band
        else:
            kern = _vote_bucket_spec
        max_batch = batch_size_of(ssl_pad)
        for at in range(0, len(idxs), max_batch):
            part = idxs[at:at + max_batch]
            arrs = _pack_bucket(code, n_mask, [runs[i] for i in part],
                                ssl_pad, m_pad)
            rc, w_up, ovf, steps = kern(
                *(torch.from_numpy(a).to(device) for a in arrs), **kw)
            vote_longer_batch.steps += steps
            rc, w_up, ovf = rc.cpu().numpy(), w_up.cpu().numpy(), \
                ovf.cpu().numpy()
            for j, idx in enumerate(part):
                ss, ssl, m = runs[idx]
                if ovf[j]:
                    vote_longer_batch.overflows += 1
                    out[idx] = _host_index(code, n_mask, ss, ssl, m)
                    continue
                R = ssl - m + 1
                counts = rc[j, :R].astype(np.int64)
                ustream = w_up[j, :R] + ss - 2
                counts += _prefix_counts(code, n_mask, ss, ssl, m, ustream)
                if counts.max() > 0:
                    out[idx] = ss + int(np.argmax(counts))
    return out


vote_longer_batch.overflows = 0
vote_longer_batch.steps = 0
