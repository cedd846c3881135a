"""The dense device scan: full match, anchor, overlay and window arrays of
every shift row, for the Python engine.

Counterpart of ribbit_tpu/scan_pallas.py (the eq/sum8 kernel and
scan_arrays_pallas) and of ribbit_tpu/scan_tpu.py (scan_arrays, the XLA
scan), whose modules import jax.

  eq_sum8      replaces scan_pallas._scan_kernel_body.  For uint8 code [L]
               (N encoded as 0) and row r = shift min_shift + r:
                 eq[r, p]   = code0[p] == code0[p + s]
                 sum8[r, p] = sum over k < 8 of code0[p+k] == code0[p+k+s]
               for p < L, code0 being the code padded with zeros (so the
               last 7 windows count pad positions as matches, as the
               Pallas kernel's zero-padded buffer does).  uint8 [nshifts, L]
               each, every row in one launch, no cap on the shift.
  scan_arrays  scan_tpu.scan_arrays' contract: eq, anchors and overlay as
               bool [nshifts, L], qual7 and qual6 as int8 [nshifts, L-7]
               (+1 qualified, 0 below the threshold, -1 the window holds an
               N), all numpy.  eq and qual7 come from eq_sum8, the anchors
               from scan_events.anchor_planes (K1, the same anchor rule as
               scan_tpu.py:64-75), the overlay and qual6's windows from
               torch ops; one device-to-host copy per array at the end.
               The JAX package's length buckets (scan_tpu.LANE) existed for
               XLA's compile cache and are not carried over.

The kernel lives in csrc/scan_dense.cu, whose header says what bounds it
on an H100.  The wrapper runs the plain version (eq_sum8_ref) for CPU
tensors only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import scan_events as se
from .backend import count_launch
from .config import (WINDOW_BITCOUNT_ANCHORED, WINDOW_BITCOUNT_SUBSTITUTION,
                     WINDOW_LENGTH, RibbitConfig)


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU or CUDA tensors)
# ---------------------------------------------------------------------------

def eq_sum8_ref(code: torch.Tensor, cfg: RibbitConfig):
    """Plain version of eq_sum8, one shift row at a time."""
    L = code.shape[0]
    code0 = torch.cat([code, torch.zeros(WINDOW_LENGTH - 1, dtype=code.dtype,
                                         device=code.device)])
    eq = torch.empty(cfg.nshifts, L, dtype=torch.uint8, device=code.device)
    sum8 = torch.empty_like(eq)
    for r in range(cfg.nshifts):
        e = se._shift_eq(code0, cfg.min_shift + r)      # [L + 7]
        eq[r] = e[:L]
        sum8[r] = se._win8(e)[:L]
    return eq, sum8


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    """csrc/scan_dense.cu, built at first use (raises if nvcc fails)."""
    import ctypes

    from .cuda_build import load
    lib = load("scan_dense")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ribbit_eq_sum8.restype = I
    lib.ribbit_eq_sum8.argtypes = [P, I, I, I, P, P, I, P]
    return lib


def eq_sum8(code: torch.Tensor, cfg: RibbitConfig):
    """(eq, sum8), each uint8 [nshifts, L], of uint8 code [L].  Kernel:
    ribbit_eq_sum8."""
    L = code.shape[0]
    if L < 1 or L >= 2**31 - 64:
        raise ValueError(f"eq_sum8: length {L} out of range")
    se._check(code, "code", torch.uint8, (L,))
    if not se._kernel_device(code):
        return eq_sum8_ref(code, cfg)
    eq = torch.empty(cfg.nshifts, L, dtype=torch.uint8, device=code.device)
    sum8 = torch.empty_like(eq)
    rc = _lib().ribbit_eq_sum8(
        code.data_ptr(), L, cfg.min_shift, cfg.nshifts, eq.data_ptr(),
        sum8.data_ptr(), code.device.index,
        torch.cuda.current_stream(code.device).cuda_stream)
    se._raise_on(rc, "eq_sum8")
    count_launch(eq_sum8)
    return eq, sum8


eq_sum8.launches = 0


def scan_arrays_eq_sum8(code: np.ndarray, cfg: RibbitConfig, device="cuda"):
    """(eq bool [nshifts, L], sum8 int32 [nshifts, L]) as numpy: the
    contract of ribbit_tpu.scan_pallas.scan_arrays_pallas."""
    c, = se.device_inputs(code, device=device)
    eq, sum8 = eq_sum8(c, cfg)
    return eq.cpu().numpy().astype(bool), sum8.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# The dense scan
# ---------------------------------------------------------------------------

def _overlay(eq: torch.Tensor, anchors: torch.Tensor,
             cfg: RibbitConfig) -> torch.Tensor:
    """Motif rows: eq | anchors of the rows at shifts m-2, m-1, m+1, m+2
    that exist and are >= 1; the other rows keep raw eq
    (scan_host.overlay_bitmaps)."""
    out = eq.clone()
    lo = cfg.min_motif - cfg.min_shift
    hi = lo + cfg.nmotifs
    for off in (-2, -1, 1, 2):
        # rows r in [lo, hi) whose neighbour row r + off lies in
        # [0, nshifts) and whose neighbour shift is >= 1
        a = max(lo, -off, 1 - off - cfg.min_shift)
        b = min(hi, cfg.nshifts - off)
        if a < b:
            out[a:b] |= anchors[a + off:b + off]
    return out


def _qualified(win: torch.Tensor, threshold: int,
               nfree: torch.Tensor) -> torch.Tensor:
    """int8: +1 where win >= threshold, 0 below, -1 where the window holds
    an N."""
    q = (win >= threshold).to(torch.int8)
    return torch.where(nfree, q, torch.full_like(q, -1))


def scan_arrays(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig,
                device="cuda"):
    """(eq, anchors, overlay, qual7, qual6) of one sequence as numpy, the
    contract of ribbit_tpu.scan_tpu.scan_arrays, computed on `device`.

    Memory: five [nshifts, L] byte arrays on the host and on the device,
    510 B/bp at the default 102 shift rows (526 MB for 1.03 Mb); the
    engine's replay is whole-contig, so the contig is not segmented."""
    L = code.shape[0]
    c, n = se.device_inputs(code, n_mask, device=device)
    eq8, sum8 = eq_sum8(c, cfg)
    eq = eq8.view(torch.bool)
    anchors = se.unpack_words(se.anchor_planes(c, cfg), L)
    overlay = _overlay(eq, anchors, cfg)
    nw = max(L - WINDOW_LENGTH + 1, 0)
    nfree = se._win8(n)[:nw] == 0
    win6 = torch.zeros(cfg.nshifts, nw, dtype=torch.uint8, device=c.device)
    for k in range(WINDOW_LENGTH):
        win6 += overlay[:, k:k + nw]
    qual7 = _qualified(sum8[:, :nw], WINDOW_BITCOUNT_SUBSTITUTION, nfree)
    qual6 = _qualified(win6, WINDOW_BITCOUNT_ANCHORED, nfree)
    return tuple(t.cpu().numpy()
                 for t in (eq, anchors, overlay, qual7, qual6))
