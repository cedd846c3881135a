"""Dense generation masks: the four int8 planes per motif channel, as one
CUDA kernel, and the event streams taken from them on the device.

Counterpart of ribbit_tpu/scan_pallas_v4.py (generate_masks_pallas_v4) and
of ribbit_tpu/scan_pallas_full.py (generate_masks_pallas,
scan_events_via_pallas), whose modules import jax.  Both Pallas kernels
compute the same planes (tests/test_pallas.py pins them bit-equal), so one
kernel serves both:

  masks  replaces scan_pallas_v4._kernel and scan_pallas_full
         ._gen_kernel_body.  For motif rows min_motif..max_motif (shift row
         r = m - min_shift) it returns int8 [nmotifs, L] planes
           q7 = win8(eq) >= 7 and no N in [p, p+8)
           q6 = win8(eq | anchors of rows r-2, r-1, r+1, r+2) >= 6, N-free
           ps = pm[p] and not pm[p-1] and the pm run from p is >= cutoff
           pm = eq and not N
         with eq and the overlay exactly as scan_events.flagwords_ref
         defines them, positions >= L counting as N and cutoff 12 - m for
         m <= 6, else m.  It reads scan_events.anchor_planes' output.

The Pallas kernels cap run lengths (at 128 in K5, 256 in K6); the port uses
the exact length, which agrees with both for every cutoff up to 128.

The kernel lives in csrc/scan_events.cu beside the event kernels, whose
pieces it shares (the code's bit-planes built once per tile, eq by funnel
shifts over them, the bit-sliced window counters) and whose anchor planes
it reads; its header says what bounds it and how a block is laid out.
The wrapper runs the plain version (masks_ref) for CPU tensors only; for a
CUDA tensor it launches the kernel or raises.

scan_events_via_masks has the extractor signature of
eventstitch.scan_events_segmented and CoreSession.set_events' stream
contract.  Its epilogue (run starts and ends by diff and nonzero over all
rows at once) runs on the planes' device, so only the events cross to the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scan_events as se
from .backend import count_launch
from .config import WINDOW_LENGTH, RibbitConfig

PLANES = ("q7", "q6", "ps", "pm")


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU or CUDA tensors)
# ---------------------------------------------------------------------------

def _long_run_starts(pm: torch.Tensor, cutoff: int) -> torch.Tensor:
    """bool [L]: the first position of every run of pm of length >=
    cutoff."""
    L = pm.shape[0]
    x = torch.zeros(L + 2, dtype=torch.int8, device=pm.device)
    x[1:-1] = pm
    d = x[1:] - x[:-1]
    starts = torch.nonzero(d == 1).flatten()
    ends = torch.nonzero(d == -1).flatten()
    out = torch.zeros(L, dtype=torch.bool, device=pm.device)
    out[starts[ends - starts >= cutoff]] = True
    return out


def masks_ref(code: torch.Tensor, n_mask: torch.Tensor,
              anchors: torch.Tensor, cfg: RibbitConfig):
    """Plain version of masks, one motif row at a time: (q7, q6, ps, pm),
    each int8 [nmotifs, L]."""
    L = code.shape[0]
    ns, r0 = cfg.nshifts, cfg.min_motif - cfg.min_shift
    nm = n_mask.bool()
    nfree = se._win8(torch.cat([nm, torch.ones(WINDOW_LENGTH - 1,
                                               dtype=torch.bool,
                                               device=nm.device)]))[:L] == 0
    out = torch.zeros(4, cfg.nmotifs, L, dtype=torch.int8,
                      device=code.device)
    unpacked: dict = {}
    for k in range(cfg.nmotifs):
        r = r0 + k
        s = cfg.min_shift + r
        eq = se._shift_eq(code, s)
        ov = eq.clone()
        for d in (-2, -1, 1, 2):
            if 0 <= r + d < ns:
                if r + d not in unpacked:
                    unpacked[r + d] = se.unpack_words(anchors[r + d], L)
                ov |= unpacked[r + d]
        unpacked.pop(r - 2, None)
        pm = eq & ~nm
        out[0, k] = (se._win8(eq) >= 7) & nfree
        out[1, k] = (se._win8(ov) >= 6) & nfree
        # shortest perfect run (parse_perfect_shiftxor.cpp:146-226)
        out[2, k] = _long_run_starts(pm, 12 - s if s <= 6 else s)
        out[3, k] = pm
    return out.unbind(0)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def masks(code: torch.Tensor, n_mask: torch.Tensor, anchors: torch.Tensor,
          cfg: RibbitConfig):
    """(q7, q6, ps, pm), each int8 [nmotifs, L], of uint8 code and n_mask
    [L] and anchor_planes' output.  Kernel: ribbit_dense_masks."""
    L = code.shape[0]
    if L < 1 or L >= 2**31 - 64:
        raise ValueError(f"masks: length {L} out of range")
    se._check(code, "code", torch.uint8, (L,))
    se._check(n_mask, "n_mask", torch.uint8, (L,))
    se._check(anchors, "anchors", torch.int32, (cfg.nshifts, (L + 31) // 32))
    kernel = se._kernel_device(code)
    if n_mask.device != code.device or anchors.device != code.device:
        raise ValueError("masks: inputs on different devices")
    if not kernel:
        return masks_ref(code, n_mask, anchors, cfg)
    out = torch.empty(4, cfg.nmotifs, L, dtype=torch.int8,
                      device=code.device)
    rc = se._lib().ribbit_dense_masks(
        code.data_ptr(), n_mask.data_ptr(), anchors.data_ptr(), L,
        cfg.min_shift, cfg.nshifts, cfg.min_motif - cfg.min_shift,
        cfg.nmotifs, out.data_ptr(), code.device.index,
        torch.cuda.current_stream(code.device).cuda_stream)
    se._raise_on(rc, "masks")
    count_launch(masks)
    return out.unbind(0)


masks.launches = 0


def _device_planes(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig,
                   device):
    """Both passes (anchor_planes, masks) on `device` from host arrays."""
    c, n = se.device_inputs(code, n_mask, device=device)
    return masks(c, n, se.anchor_planes(c, cfg), cfg)


def generate_masks(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig,
                   device="cuda"):
    """(q7, q6, ps, pm) as numpy int8 [nmotifs, L]: the contract of
    ribbit_tpu.scan_pallas_v4.generate_masks_pallas_v4."""
    return tuple(p.cpu().numpy()
                 for p in _device_planes(code, n_mask, cfg, device))


# ---------------------------------------------------------------------------
# Event epilogue (on the planes' device)
# ---------------------------------------------------------------------------

def _transitions(plane: torch.Tensor) -> torch.Tensor:
    """int8 [rows, n + 1]: +1 where a run of the 0/1 plane [rows, n] starts,
    -1 at its exclusive end."""
    z = torch.zeros(plane.shape[0], 1, dtype=torch.int8,
                    device=plane.device)
    return torch.diff(plane, dim=1, prepend=z, append=z)


def _stream(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
            nrows: int):
    """(starts, ends, offsets) int64 numpy arrays, channel-major, from
    row-sorted run coordinates."""
    offs = torch.zeros(nrows + 1, dtype=torch.int64, device=rows.device)
    offs[1:] = torch.bincount(rows, minlength=nrows).cumsum(0)
    return (starts.cpu().numpy(), ends.cpu().numpy(), offs.cpu().numpy())


def _run_stream(plane: torch.Tensor):
    """Every maximal run of a 0/1 plane [rows, n], as a stream."""
    n = plane.shape[1]
    d = _transitions(plane).flatten()
    st = torch.nonzero(d == 1).flatten()
    en = torch.nonzero(d == -1).flatten()
    return _stream(st // (n + 1), st % (n + 1), en % (n + 1), plane.shape[0])


def _perfect_stream(ps: torch.Tensor, pm: torch.Tensor):
    """The pm runs that ps flags: each flag is a pm-run start, and its end
    is the first run end after it in the flattened transitions."""
    L = pm.shape[1]
    en = torch.nonzero(_transitions(pm).flatten() == -1).flatten()
    fl = torch.nonzero(ps.flatten()).flatten()
    rows, starts = fl // L, fl % L
    base = rows * (L + 1)
    ends = en[torch.searchsorted(en, base + starts)] - base
    return _stream(rows, starts, ends, pm.shape[0])


def scan_events_via_masks(code: np.ndarray, n_mask: np.ndarray,
                          cfg: RibbitConfig, device="cuda"):
    """(perfect, q7, q6) event streams for CoreSession.set_events from the
    dense planes, with scan_events_via_pallas's epilogue: q runs over
    [0, L - 7), perfect starts at the ps flags, each ending where the pm
    run it opens ends."""
    q7, q6, ps, pm = _device_planes(code, n_mask, cfg, device)
    nw = max(code.shape[0] - WINDOW_LENGTH + 1, 0)
    return (_perfect_stream(ps, pm), _run_stream(q7[:, :nw]),
            _run_stream(q6[:, :nw]))
