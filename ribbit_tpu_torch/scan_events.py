"""Device event extraction: the shift-XOR scan as two CUDA kernels, plus
the host decode of their bitmap words into event streams.

Counterpart of ribbit_tpu/scan_events_pallas.py (whose module imports jax,
so the decode glue below is a copy; the C decoder it drives,
csrc/ribbit_events.c, is the repository's C core, built by native.py).

  anchor_planes  replaces the Pallas anchor pass (_anchor_kernel).  The
                 planes never leave the device, so their layout is the
                 port's own: one bit-word per 32 positions per shift row,
                 int32 [nshifts, ceil(L/32)].
  event_words    replaces the Pallas event pass (_kernel).  Its output is
                 the fixed contract the C decoder reads: int32
                 [ceil(nsp/8), L], bits 0-7 q6, 8-15 q7, 16-23 pm of the
                 plane's 8 shift rows.  It also stores the packed
                 overlay of the motif rows in its `overlay` tensor, int32
                 [nmotifs, overlay_row_words(L)]: the C core's packed
                 overlay cache (CoreSession.set_overlay), which the
                 extraction keeps on the device for the replay.

The kernels live in csrc/scan_events.cu, whose header says what they
compute, what bounds them on an H100 and how the design answers it.  Each
wrapper runs its plain PyTorch version (anchor_planes_ref, flagwords_ref)
for CPU tensors only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from . import tracing
from .backend import count_launch, require_cuda
from .config import ANCHOR_SIZE, WINDOW_LENGTH, RibbitConfig

OUT_ROWS = 8        # shift rows per event word (3 fields of 8 bits)
K1_ROWS = 16        # shift rows per word of the Pallas anchor planes


def nsp_of(cfg: RibbitConfig) -> int:
    """Shift rows the event planes cover (scan_pallas_v2._nsp_of)."""
    ns = cfg.max_shift - cfg.min_shift + 1
    return max(32, ((ns + 7) // 8) * 8)


def overlay_row_words(L: int) -> int:
    """int32 words of one packed overlay row of L positions: the C core's
    uint64 words, ceil(L / 64), two each."""
    return 2 * ((L + 63) >> 6)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU or CUDA tensors)
# ---------------------------------------------------------------------------

def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., L] -> int32 [..., ceil(L/32)], bit j of word w =
    position 32w + j."""
    L = bits.shape[-1]
    W = (L + 31) // 32
    pad = torch.zeros(*bits.shape[:-1], W * 32 - L, dtype=torch.bool,
                      device=bits.device)
    b = torch.cat([bits, pad], dim=-1).reshape(*bits.shape[:-1], W, 32)
    sh = torch.arange(32, device=bits.device, dtype=torch.int64)
    v = (b.to(torch.int64) << sh).sum(dim=-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def unpack_words(words: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of pack_words: int32 [..., W] -> bool [..., L].  Byte ops
    only (little-endian: byte k of a word holds positions 8k..8k+7), so
    the temporaries take 1 B per bit."""
    b = words.contiguous().view(torch.uint8)
    sh = torch.arange(8, device=words.device, dtype=torch.uint8)
    bits = (b.unsqueeze(-1) >> sh) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :L].view(torch.bool)


def _shift_eq(code: torch.Tensor, s: int) -> torch.Tensor:
    """bool [L]: code[p] == code[p + s], code reading 0 past the end."""
    L = code.shape[0]
    shifted = torch.zeros_like(code)
    if s < L:
        shifted[:L - s] = code[s:]
    return code == shifted


def _anchor_row(b: torch.Tensor, s: int, hi: int) -> torch.Tensor:
    """Anchors of one row: maximal runs of b (already 0 from hi on) of
    length in [ANCHOR_SIZE, 2s) that close before hi."""
    L = b.shape[0]
    x = torch.zeros(L + 2, dtype=torch.int8, device=b.device)
    x[1:-1] = b
    d = x[1:] - x[:-1]
    starts = torch.nonzero(d == 1).flatten()
    ends = torch.nonzero(d == -1).flatten()
    lens = ends - starts
    keep = (ends < hi) & (lens >= ANCHOR_SIZE) & (lens < 2 * s)
    delta = torch.zeros(L + 1, dtype=torch.int32, device=b.device)
    delta[starts[keep]] = 1
    delta[ends[keep]] = -1
    return delta.cumsum(0)[:L] > 0


def anchor_planes_ref(code: torch.Tensor, cfg: RibbitConfig) -> torch.Tensor:
    """Plain version of anchor_planes, one shift row at a time."""
    L = code.shape[0]
    pos = torch.arange(L, device=code.device)
    rows = []
    for r in range(cfg.nshifts):
        s = cfg.min_shift + r
        b = _shift_eq(code, s) & (pos < L - s)
        rows.append(pack_words(_anchor_row(b, s, L - s)))
    return torch.stack(rows)


def _win8(x: torch.Tensor) -> torch.Tensor:
    """int [L]: x[p] + ... + x[p+7], zeros past the end."""
    L = x.shape[0]
    xp = torch.cat([x.to(torch.int8),
                    torch.zeros(WINDOW_LENGTH - 1, dtype=torch.int8,
                                device=x.device)])
    return sum(xp[k:k + L] for k in range(WINDOW_LENGTH))


def _overlay_rows(code: torch.Tensor, anchors: torch.Tensor,
                  cfg: RibbitConfig, rows: range):
    """(eq, overlay) bool [L] of the shift rows r of `rows`, in order: eq of
    row r (0 for r >= nshifts) or'd with the anchors of rows r - 2, r - 1,
    r + 1, r + 2 (those in [0, nshifts)), each anchor row unpacked once."""
    L, ns = code.shape[0], cfg.nshifts
    unpacked: dict = {}
    for r in rows:
        eq = _shift_eq(code, cfg.min_shift + r) if r < ns else torch.zeros(
            L, dtype=torch.bool, device=code.device)
        ov = eq.clone()
        for d in (-2, -1, 1, 2):
            if 0 <= r + d < ns:
                if r + d not in unpacked:
                    unpacked[r + d] = unpack_words(anchors[r + d], L)
                ov |= unpacked[r + d]
        unpacked.pop(r - 2, None)
        yield eq, ov


def overlay_words_ref(code: torch.Tensor, anchors: torch.Tensor,
                      cfg: RibbitConfig) -> torch.Tensor:
    """Plain version of event_words' overlay output: int32 [nmotifs,
    overlay_row_words(L)], row d the overlay of motif min_motif + d packed
    (pack_words), bits from L on 0."""
    L = code.shape[0]
    r0 = cfg.min_motif - cfg.min_shift
    out = torch.zeros(cfg.nmotifs, overlay_row_words(L), dtype=torch.int32,
                      device=code.device)
    for d, (_eq, ov) in enumerate(_overlay_rows(code, anchors, cfg,
                                                range(r0, r0 + cfg.nmotifs))):
        out[d, :(L + 31) // 32] = pack_words(ov)
    return out


def flagwords_ref(code: torch.Tensor, n_mask: torch.Tensor,
                  anchors: torch.Tensor, cfg: RibbitConfig) -> torch.Tensor:
    """Plain version of event_words, one shift row at a time."""
    L = code.shape[0]
    nsp = nsp_of(cfg)
    nm = n_mask.bool()
    # the right pad counts as N, so windows reaching past L are not N-free
    nfree = _win8(torch.cat([nm, torch.ones(WINDOW_LENGTH - 1,
                                            dtype=torch.bool,
                                            device=nm.device)]))[:L] == 0
    out = torch.zeros(nsp // OUT_ROWS, L, dtype=torch.int32,
                      device=code.device)
    for r, (eq, ov) in enumerate(_overlay_rows(code, anchors, cfg,
                                               range(nsp))):
        q6 = (_win8(ov) >= 6) & nfree
        q7 = (_win8(eq) >= 7) & nfree
        pm = eq & ~nm
        g, bit = divmod(r, OUT_ROWS)
        out[g] |= ((q6.to(torch.int32) << bit)
                   | (q7.to(torch.int32) << (OUT_ROWS + bit))
                   | (pm.to(torch.int32) << (2 * OUT_ROWS + bit)))
    return out


def anchors_to_k1_layout(anchors: torch.Tensor, L: int,
                         cfg: RibbitConfig) -> torch.Tensor:
    """Port anchor planes -> the Pallas anchor pass's layout: int32
    [ceil(nsp/16), L], bit r % 16 of plane r // 16 = anchor of row r."""
    nplanes = (nsp_of(cfg) + K1_ROWS - 1) // K1_ROWS
    out = torch.zeros(nplanes, L, dtype=torch.int32, device=anchors.device)
    for r in range(cfg.nshifts):
        g, bit = divmod(r, K1_ROWS)
        out[g] |= unpack_words(anchors[r], L).to(torch.int32) << bit
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/scan_events.cu, built at first use (raises if nvcc fails)."""
    from .cuda_build import load
    lib = load("scan_events")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ribbit_anchor_planes.restype = I
    lib.ribbit_anchor_planes.argtypes = [P, I, I, I, P, I, I, P]
    lib.ribbit_event_words.restype = I
    lib.ribbit_event_words.argtypes = [P, P, P, I, I, I, I, P, I, I, P, I,
                                       P]
    lib.ribbit_dense_masks.restype = I
    lib.ribbit_dense_masks.argtypes = [P, P, P, I, I, I, I, I, P, I, P]
    return lib


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _kernel_device(t: torch.Tensor) -> bool:
    """True if t is a CUDA tensor (the kernel runs), False if it is a CPU
    tensor (the plain version runs); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {t.device}")


def anchor_planes(code: torch.Tensor, cfg: RibbitConfig) -> torch.Tensor:
    """Anchor bit-planes int32 [nshifts, ceil(L/32)] of uint8 code [L]
    (N encoded as 0).  Kernel: ribbit_anchor_planes."""
    L = code.shape[0]
    if L < 1 or L >= 2**31 - 64:
        raise ValueError(f"anchor_planes: length {L} out of range")
    _check(code, "code", torch.uint8, (L,))
    if not _kernel_device(code):
        return anchor_planes_ref(code, cfg)
    W = (L + 31) // 32
    out = torch.empty(cfg.nshifts, W, dtype=torch.int32, device=code.device)
    rc = _lib().ribbit_anchor_planes(
        code.data_ptr(), L, cfg.min_shift, cfg.nshifts, out.data_ptr(), W,
        code.device.index, torch.cuda.current_stream(code.device).cuda_stream)
    _raise_on(rc, "anchor_planes")
    count_launch(anchor_planes)
    return out


anchor_planes.launches = 0


def event_words(code: torch.Tensor, n_mask: torch.Tensor,
                anchors: torch.Tensor, cfg: RibbitConfig,
                overlay: torch.Tensor) -> torch.Tensor:
    """Event bitmap words int32 [ceil(nsp/8), L] (the C decoder's layout)
    of uint8 code and n_mask [L] and anchor_planes' output; the same pass
    writes the packed overlay into `overlay`, int32 [nmotifs,
    overlay_row_words(L)] on the same device (overlay_words_ref).  Kernel:
    ribbit_event_words.

    The code holds encode's values 0-3 with N encoded as 0: the kernel
    compares codes through their two low bit-planes, so a value above 3
    would match its low bits.  That is the caller's contract and is not
    checked here (a check would synchronise with the card)."""
    L = code.shape[0]
    if L < 1 or L >= 2**31 - 64:
        raise ValueError(f"event_words: length {L} out of range")
    _check(code, "code", torch.uint8, (L,))
    _check(n_mask, "n_mask", torch.uint8, (L,))
    _check(anchors, "anchors", torch.int32, (cfg.nshifts, (L + 31) // 32))
    _check(overlay, "overlay", torch.int32,
           (cfg.nmotifs, overlay_row_words(L)))
    kernel = _kernel_device(code)
    if any(t.device != code.device for t in (n_mask, anchors, overlay)):
        raise ValueError("event_words: inputs on different devices")
    if not kernel:
        overlay.copy_(overlay_words_ref(code, anchors, cfg))
        return flagwords_ref(code, n_mask, anchors, cfg)
    ngroups = nsp_of(cfg) // OUT_ROWS
    out = torch.empty(ngroups, L, dtype=torch.int32, device=code.device)
    rc = _lib().ribbit_event_words(
        code.data_ptr(), n_mask.data_ptr(), anchors.data_ptr(), L,
        cfg.min_shift, cfg.nshifts, ngroups, out.data_ptr(),
        cfg.min_motif - cfg.min_shift, cfg.nmotifs, overlay.data_ptr(),
        code.device.index, torch.cuda.current_stream(code.device).cuda_stream)
    _raise_on(rc, "event_words")
    count_launch(event_words)
    return out


event_words.launches = 0


# ---------------------------------------------------------------------------
# Bitmap-word decoding (host): numpy reference + threaded C decoder,
# copied from ribbit_tpu/scan_events_pallas.py:400-521
# ---------------------------------------------------------------------------

def _bit_of(row: int, field: int) -> int:
    """Bit position of `field` (0=q6, 1=q7, 2=pm) for word row `row`
    (0..OUT_ROWS-1): uniform field stride OUT_ROWS."""
    return OUT_ROWS * field + row


def _decode_numpy(w: np.ndarray, cfg: RibbitConfig):
    """Reference decoder: bitmap-word planes -> the three event streams
    ((starts, ends, offsets) per stream, channel-major, in the order
    (perfect, q7, q6)).  Run starts/ends come from bitmap transitions; the
    perfect generation cutoff is applied on the exact run length."""
    uw = w.view(np.uint32)
    nm = cfg.nmotifs
    r0 = cfg.min_motif - cfg.min_shift
    streams = []
    for field in (0, 1, 2):                 # q6, q7, pm
        starts: list = []
        ends: list = []
        offs = [0]
        for didx in range(nm):
            row = r0 + didx
            g, bit = divmod(row, OUT_ROWS)
            bm = ((uw[g] >> np.uint32(_bit_of(bit, field))) & 1).astype(
                np.int8)
            d = np.diff(bm, prepend=np.int8(0), append=np.int8(0))
            s_pos = np.flatnonzero(d == 1).astype(np.int64)
            e_pos = np.flatnonzero(d == -1).astype(np.int64)
            if field == 2:                  # perfect: length >= cutoff
                m = cfg.min_shift + row
                cutoff = 12 - m if m <= 6 else m
                keep = (e_pos - s_pos) >= cutoff
                s_pos, e_pos = s_pos[keep], e_pos[keep]
            starts.append(s_pos)
            ends.append(e_pos)
            offs.append(offs[-1] + s_pos.shape[0])
        streams.append((np.concatenate(starts) if starts else
                        np.zeros(0, np.int64),
                        np.concatenate(ends) if ends else
                        np.zeros(0, np.int64),
                        np.asarray(offs, dtype=np.int64)))
    return streams[2], streams[1], streams[0]


def _decode_c(w: np.ndarray, cfg: RibbitConfig):
    """Threaded C decoder (csrc/ribbit_events.c), one thread per plane;
    same contract as _decode_numpy.  Span "extract.decode", counting the
    events of the three streams and the overflow re-runs of a plane."""
    with tracing.span("extract.decode") as sp:
        streams, retries = _decode_planes(w, cfg)
        sp.set(events=sum(st[0].shape[0] for st in streams),
               retries=retries)
    return streams


def _decode_planes(w: np.ndarray, cfg: RibbitConfig):
    """(_decode_c's streams, the overflow re-runs of all planes)."""
    from concurrent.futures import ThreadPoolExecutor
    from .native import get_events_lib

    lib = get_events_lib()

    nm = cfg.nmotifs
    r0 = cfg.min_motif - cfg.min_shift
    ngroups, L = w.shape
    w = np.ascontiguousarray(w)
    P32 = ctypes.POINTER(ctypes.c_int32)
    P64 = ctypes.POINTER(ctypes.c_int64)
    OR = OUT_ROWS

    def one_group(g):
        # channels this plane contributes (global rows OR*g..OR*(g+1))
        lo_row = max(OR * g, r0)
        hi_row = min(OR * g + OR, r0 + nm)
        if lo_row >= hi_row:
            return None
        # perfect generation cutoffs by word row (12-m if m<=6 else m;
        # parse_perfect_shiftxor.cpp:146-226)
        mrow = cfg.min_shift + OR * g + np.arange(OR, dtype=np.int64)
        cutoffs = np.where(mrow <= 6, 12 - mrow, mrow)
        # per-channel bucket capacity; the retry loop grows past the
        # reported need on overflow
        cap = max(1 << 12, L // 64)
        for retry in itertools.count():
            bufs = [np.empty(OR * cap, dtype=np.int32) for _ in range(6)]
            cnt = np.zeros(3 * OR, dtype=np.int64)
            rc = lib.ribbit_decode_bitmaps(
                w[g].ctypes.data_as(P32), L, lo_row - OR * g,
                hi_row - OR * g, cutoffs.ctypes.data_as(P64), cap,
                *(b.ctypes.data_as(P32) for b in bufs),
                cnt.ctypes.data_as(P64))
            if rc == 0:
                return (bufs, cnt, cap, lo_row - OR * g, hi_row - OR * g,
                        retry)
            if rc < 0:
                raise RuntimeError("bitmap decode: malformed plane")
            cap = int(rc + (rc >> 2))

    with ThreadPoolExecutor(max_workers=min(8, ngroups)) as ex:
        results = list(ex.map(one_group, range(ngroups)))

    streams = []
    for k in range(3):     # 0 = q6, 1 = q7, 2 = perfect (decoder order)
        ss, es, per_ch = [], [], []
        for res in results:
            if res is None:
                continue
            bufs, cnt, cap, b_lo, b_hi, _retry = res
            for b in range(b_lo, b_hi):
                n = int(cnt[OUT_ROWS * k + b])
                ss.append(bufs[2 * k][b * cap:b * cap + n])
                es.append(bufs[2 * k + 1][b * cap:b * cap + n])
                per_ch.append(n)
        s_arr = (np.concatenate(ss).astype(np.int64) if ss else
                 np.zeros(0, np.int64))
        e_arr = (np.concatenate(es).astype(np.int64) if es else
                 np.zeros(0, np.int64))
        offsets = np.zeros(nm + 1, dtype=np.int64)
        np.cumsum(per_ch, out=offsets[1:1 + len(per_ch)])
        if len(per_ch) < nm:
            offsets[1 + len(per_ch):] = offsets[len(per_ch)]
        streams.append((s_arr, e_arr, offsets))
    retries = sum(res[-1] for res in results if res is not None)
    return (streams[2], streams[1], streams[0]), retries


def device_inputs(*arrays: np.ndarray, device):
    """uint8 tensors on `device` from encode's host arrays (code, n_mask);
    raises if CUDA is asked for and absent."""
    if any(np.dtype(a.dtype).itemsize != 1 for a in arrays):
        raise ValueError(f"want 1-byte code and n_mask (as encode gives), "
                         f"got {[str(a.dtype) for a in arrays]}")
    require_cuda(device)
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.uint8))
                 .to(dev) for a in arrays)


class EventStreams(tuple):
    """(perfect, q7, q6) event streams, as CoreSession.set_events takes
    them, and `overlay`: the packed overlay words of the same positions
    (int32 [nmotifs, overlay_row_words(L)], on the device that made them;
    CoreSession.set_overlay), or None."""

    def __new__(cls, streams, overlay=None):
        self = super().__new__(cls, streams)
        self.overlay = overlay
        return self


def flagwords(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig,
              device="cuda"):
    """(event bitmap words of one sequence as int32 [ceil(nsp/8), L] on the
    host, its packed overlay words on `device`): both passes on `device`,
    then one device-to-host copy of the event words.  Spans "extract.h2d",
    "extract.kernels" (the launches) and "extract.d2h" (the copy, with the
    wait on the kernels)."""
    with tracing.span("extract.h2d", bytes=code.nbytes + n_mask.nbytes):
        c, n = device_inputs(code, n_mask, device=device)
    with tracing.span("extract.kernels"):
        ov = torch.empty(cfg.nmotifs, overlay_row_words(code.shape[0]),
                         dtype=torch.int32, device=c.device)
        w = event_words(c, n, anchor_planes(c, cfg), cfg, ov)
    with tracing.span("extract.d2h", bytes=w.numel() * w.element_size()):
        return w.cpu().numpy(), ov


def scan_events_device(code: np.ndarray, n_mask: np.ndarray,
                       cfg: RibbitConfig, device="cuda") -> EventStreams:
    """Device event extraction + C transition decode: (perfect, q7, q6)
    streams, the contract of ribbit_tpu.scan_events_pallas
    .scan_events_device and CoreSession.set_events, with the packed
    overlay left on `device`.  Span "extract" (the bp it covers) over the
    four of flagwords and _decode_c."""
    with tracing.span("extract", bp=code.shape[0]):
        w, ov = flagwords(code, n_mask, cfg, device)
        return EventStreams(_decode_c(w, cfg), ov)
