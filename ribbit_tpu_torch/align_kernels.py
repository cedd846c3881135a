"""SSW forward scoring of device-batched refinement: two CUDA kernels and
their plain PyTorch version.

Counterpart of ribbit_tpu/align_pallas_v3.py and ribbit_tpu/align_pallas.py
(whose modules import jax).  Both compute the exact forward pass of
SSW (ribbit_tpu/align.py ssw_align) for a batch of (read, ref) pairs of codes 0-4 and return
int32 [4, n]: score, end_ref, end_read and first_hit (the first column
whose max equals the pair's terminate target, in terminate mode; else -1).

  ssw_forward_small  replaces align_pallas_v3._fwd_kernel (one pair per
                     lane) and align_pallas_v2._fwd_kernel: a warp per
                     pair, for pairs within fits().
  ssw_forward_large  replaces align_pallas._fwd_kernel (reads on lanes,
                     prefix-max F): a block of 8 warps per pair, any length.

Both are one striped wavefront (csrc/ssw_forward.cu): each lane owns a
strip of a band of read rows, with H and E in registers, and hands its
bottom row to the next lane each step.  launch_plan, a pure function of
the lengths, picks each pair's strip bucket and the launch order.

Pairs travel ragged (Pairs: codes concatenated with int64 offsets), with
no padding to the batch maximum; the Pallas kernels' padded layouts were a
Mosaic constraint, not part of the contract.  Splitting a batch by fits()
is the caller's work (refine_batched._forward), as in the JAX
package.  The kernels live in csrc/ssw_forward.cu, whose header says what
bounds them on an H100.  Each wrapper runs the plain version
(ssw_forward_ref) for CPU tensors only; for a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from .backend import count_launch, require_cuda

GAP_O = 3
GAP_E = 1
WORD_MAX = 32767
RB = 8                   # fits(): rows are counted in blocks of 8
MAX_ROWS = 2560          # fits(): 3R + C cap of the one-pair-per-lane class
SMALL_LANES = 32         # a warp per pair
LARGE_LANES = 256        # a block of 8 warps per pair


def fits(max_read_len, max_ref_len):
    """True for pairs of the one-pair-per-lane class (a copy of
    ribbit_tpu.align_pallas_v3.fits, whose VMEM budget defines it); on
    arrays of lengths, their mask."""
    R = RB * np.maximum(1, -(-np.asarray(max_read_len) // RB))
    C = 8 * np.maximum(1, -(-np.asarray(max_ref_len) // 8))
    return 3 * R + C <= MAX_ROWS


class Pairs(NamedTuple):
    """A ragged batch of (read, ref) pairs on one device."""
    read: torch.Tensor       # uint8 [sum of read lengths], codes 0-4
    read_off: torch.Tensor   # int64 [n + 1]
    ref: torch.Tensor        # uint8 [sum of ref lengths]
    ref_off: torch.Tensor    # int64 [n + 1]
    term: torch.Tensor       # int32 [n]: terminate target, -1 for none
    rlen: np.ndarray         # int64 [n] read lengths, on the host
    clen: np.ndarray         # int64 [n] ref lengths, on the host

    @property
    def n(self) -> int:
        return self.rlen.shape[0]


def _concat(seqs, n: int):
    lens = np.fromiter((s.shape[0] for s in seqs), np.int64, n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    cat = (np.concatenate([np.asarray(s).view(np.uint8) for s in seqs])
           if n else np.zeros(0, np.uint8))
    return cat, off, lens


def pack_pairs(reads, refs, terms=None, device="cuda") -> Pairs:
    """Pairs on `device` from lists of 1-byte code arrays (values 0-4) and
    optional terminate targets (None or -1: forward mode)."""
    n = len(reads)
    if len(refs) != n or (terms is not None and len(terms) != n):
        raise ValueError("pack_pairs: reads, refs and terms differ in "
                         "length")
    read, read_off, _ = _concat(reads, n)
    ref, ref_off, _ = _concat(refs, n)
    term = np.full(n, -1, np.int32)
    if terms is not None:
        term[:] = [-1 if t is None else t for t in terms]
    return pack_flat(read, read_off, ref, ref_off, term, device)


def pack_flat(read, read_off, ref, ref_off, term=None,
              device="cuda") -> Pairs:
    """Pairs on `device` from flat 1-byte code buffers (values 0-4) with
    int64 offsets [n + 1] and optional int32 terminate targets (-1:
    forward mode; None: all forward)."""
    require_cuda(device)
    read_off = np.ascontiguousarray(read_off, np.int64)
    ref_off = np.ascontiguousarray(ref_off, np.int64)
    n = read_off.shape[0] - 1
    term = (np.full(n, -1, np.int32) if term is None
            else np.ascontiguousarray(term, np.int32))
    to = lambda a: torch.from_numpy(a).to(device)
    return Pairs(to(np.ascontiguousarray(read).view(np.uint8)), to(read_off),
                 to(np.ascontiguousarray(ref).view(np.uint8)), to(ref_off),
                 to(term), np.diff(read_off), np.diff(ref_off))


def _gather(cat, off, idx, lens: np.ndarray, reverse: bool):
    """The runs cat[off[i]:off[i] + lens[k]] for i = idx[k] (reversed when
    `reverse`) concatenated on cat's device, and their offsets."""
    dev = cat.device
    new_off = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=new_off[1:])
    total = int(new_off[-1])
    n = torch.from_numpy(lens).to(dev)
    o = torch.from_numpy(new_off).to(dev)
    start = off[idx] + (n - 1 if reverse else 0)
    pos = torch.arange(total, device=dev) - torch.repeat_interleave(
        o[:-1], n, output_size=total)
    src = torch.repeat_interleave(start, n, output_size=total)
    return cat[src - pos if reverse else src + pos], o


def take(p: Pairs, idx, rlen=None, clen=None, term=None,
         reverse: bool = False) -> Pairs:
    """Pairs idx of p, gathered on p's device: each read and ref cut to
    its first rlen[k] and clen[k] codes when those are given (at most its
    length; checked), reversed when `reverse`, with terminate targets
    `term` (default p's)."""
    idx = np.ascontiguousarray(idx, np.int64)
    rlen = p.rlen[idx] if rlen is None else np.asarray(rlen, np.int64)
    clen = p.clen[idx] if clen is None else np.asarray(clen, np.int64)
    if rlen.shape != idx.shape or clen.shape != idx.shape:
        raise ValueError("take: rlen and clen need one length a pair")
    if ((rlen < 0) | (rlen > p.rlen[idx]) | (clen < 0)
            | (clen > p.clen[idx])).any():
        raise ValueError("take: a cut is longer than its pair")
    dev = p.read.device
    it = torch.from_numpy(idx).to(dev)
    read, read_off = _gather(p.read, p.read_off, it, rlen, reverse)
    ref, ref_off = _gather(p.ref, p.ref_off, it, clen, reverse)
    t = (p.term[it] if term is None else
         torch.from_numpy(np.ascontiguousarray(term, np.int32)).to(dev))
    return Pairs(read, read_off, ref, ref_off, t, rlen, clen)


def _kernel_device(p: Pairs) -> bool:
    """Checks the batch; True if it lies on a CUDA device (the kernel runs),
    False on the CPU (the plain version runs); raises for anything else."""
    n = p.n
    want = (("read", torch.uint8, (int(p.rlen.sum()),)),
            ("read_off", torch.int64, (n + 1,)),
            ("ref", torch.uint8, (int(p.clen.sum()),)),
            ("ref_off", torch.int64, (n + 1,)),
            ("term", torch.int32, (n,)))
    for name, dtype, shape in want:
        t = getattr(p, name)
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != p.read.device:
            raise ValueError(f"{name} is on {t.device}, read on "
                             f"{p.read.device}")
    if p.clen.shape != (n,):
        raise ValueError("rlen and clen differ in length")
    if p.read.device.type == "cpu":
        return False
    if p.read.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {p.read.device}")


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU or CUDA tensors)
# ---------------------------------------------------------------------------

def _padded(cat: torch.Tensor, off: torch.Tensor, lens: torch.Tensor,
            width: int):
    """[n, width] codes of a ragged batch, 4 (N) past each length, and
    the mask of real positions."""
    pos = torch.arange(width, device=cat.device)
    valid = pos < lens[:, None]
    idx = (off[:-1, None] + pos).clamp(max=max(cat.numel() - 1, 0))
    codes = cat[idx] if cat.numel() else torch.zeros_like(idx,
                                                          dtype=torch.uint8)
    return torch.where(valid, codes.to(torch.int32), 4), valid


def ssw_forward_ref(p: Pairs) -> torch.Tensor:
    """Plain version of both kernels: vectorised over pairs and rows, one
    step per ref column, F from torch.cummax (align_pallas.py's formula).
    int32 [4, n] on the pairs' device."""
    dev, n = p.read.device, p.n
    R = max(int(p.rlen.max(initial=0)), 1)
    C = int(p.clen.max(initial=0))
    rlen = torch.from_numpy(p.rlen).to(dev)
    clen = torch.from_numpy(p.clen).to(dev)
    reads, valid = _padded(p.read, p.read_off, rlen, R)
    refs, _ = _padded(p.ref, p.ref_off, clen, max(C, 1))
    term = p.term.to(torch.int32)
    rows = torch.arange(R, device=dev, dtype=torch.int32)
    zero_col = torch.zeros(n, 1, dtype=torch.int32, device=dev)
    H = torch.zeros(n, R, dtype=torch.int32, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros(n, dtype=torch.int32, device=dev)
    end_ref = torch.full_like(best, -1)
    end_read = torch.full_like(best, -1)
    first_hit = torch.full_like(best, -1)
    for i in range(C):
        frozen = (term >= 0) & (first_hit >= 0)
        active = (clen > i) & ~frozen
        rc = refs[:, i:i + 1]
        sc = torch.where((rc == reads) & (rc < 4), 2, -2)
        diag = (torch.cat([zero_col, H[:, :-1]], 1) + sc).clamp(max=WORD_MAX)
        h0 = torch.where(valid, torch.maximum(diag, E).clamp(min=0), 0)
        P = torch.cummax(h0 + rows * GAP_E, dim=1).values
        F = (P[:, :-1] - GAP_O - rows[:-1] * GAP_E).clamp(min=0)
        Hn = torch.where(valid, torch.maximum(h0, torch.cat([zero_col, F], 1)),
                         0)
        En = torch.where(valid, torch.maximum(E - GAP_E, Hn - GAP_O)
                         .clamp(min=0), 0)
        colmax = Hn.max(dim=1).values
        jmin = torch.where(Hn == colmax[:, None], rows, R).min(dim=1).values
        improved = active & (colmax > best)
        best = torch.where(improved, colmax, best)
        end_ref = torch.where(improved, i, end_ref)
        end_read = torch.where(improved, jmin, end_read)
        hit = active & (first_hit < 0) & (colmax == term) & (term >= 0)
        first_hit = torch.where(hit, i, first_hit)
        H = torch.where(active[:, None], Hn, H)
        E = torch.where(active[:, None], En, E)
    return torch.stack([best, end_ref, end_read, first_hit]).to(torch.int32)


# ---------------------------------------------------------------------------
# Launch plan (a pure function of the lengths; the CPU tests cover it)
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """How a batch goes through one kernel."""
    key: np.ndarray          # int64 [n]: the launch order is argsort(key),
                             # bucket by bucket in the strips' order, then
                             # cells descending
    counts: np.ndarray       # int32 [len(strips)]: pairs of each bucket
    strip: np.ndarray        # int64 [n]: rows a lane owns in a band, by pair
    bands: np.ndarray        # int64 [n]: bands of lanes x strip rows


def launch_plan(rlen, clen, lanes: int, strips) -> Plan:
    """Each pair's strip, from `strips` (rows a lane, descending: the
    kernel's table, ribbit_ssw_strips): the smallest that holds its rows on
    `lanes` lanes in one band, else the largest in as many bands as it
    takes.  The largest strips launch first; within a bucket the pairs go
    by cells, largest first, so a block's pairs are alike in size and the
    longest walks start first."""
    rlen = np.asarray(rlen, np.int64)
    clen = np.asarray(clen, np.int64)
    table = np.asarray(strips, np.int64)
    rows = np.maximum(rlen, 1)
    need = np.minimum(-(-rows // lanes), table[0])
    # the last bucket (smallest strip) that still holds `need` rows
    bucket = np.searchsorted(-table, -need, side="right") - 1
    strip = table[bucket]
    bands = -(-rows // (lanes * strip))
    key = (bucket << 50) - np.minimum(rlen * clen, (1 << 50) - 1)
    counts = np.bincount(bucket, minlength=len(table)).astype(np.int32)
    return Plan(key, counts, strip, bands)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/ssw_forward.cu, built at first use (raises if nvcc fails)."""
    from .cuda_build import load
    lib = load("ssw_forward")
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ribbit_ssw_forward_small, lib.ribbit_ssw_forward_large):
        fn.restype = I
        fn.argtypes = [P, P, P, P, P, P, P, I, I, P, P, I, P, P, P, P]
    lib.ribbit_ssw_strips.restype = I
    lib.ribbit_ssw_strips.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    return lib


@functools.cache
def strips() -> tuple:
    """The kernels' strip buckets (rows a lane, descending), from
    csrc/ssw_forward.cu's table."""
    table = ctypes.c_void_p()
    k = _lib().ribbit_ssw_strips(ctypes.byref(table))
    return tuple(ctypes.cast(table, ctypes.POINTER(ctypes.c_int32))[:k])


@functools.cache
def _fork(device: torch.device):
    """What the kernels' entries fork the strip buckets onto, made once
    per device: one stream per bucket (their handles as a C array), the
    fork and join events, and the lock that keeps two callers from
    interleaving on them."""
    streams = tuple(torch.cuda.Stream(device) for _ in strips())
    handles = (ctypes.c_void_p * len(streams))(
        *(s.cuda_stream for s in streams))
    events = (torch.cuda.Event(), torch.cuda.Event())
    for e in events:                   # a torch event exists once recorded
        e.record(streams[0])
    return streams, handles, events, threading.Lock()


def prepare(p: Pairs, lanes: int, entry: str):
    """A wrapper's work before its launches: the plan, its order on the
    card (sorted there), the output and the scratch for pairs of more than
    one band.  Returns (out, launch); launch() enqueues one kernel instance
    per bucket of the plan, each on a stream of its own forked from the
    current stream and joined back to it, and raises if CUDA refuses
    one."""
    dev, n = p.read.device, p.n
    out = torch.empty(4, n, dtype=torch.int32, device=dev)
    plan = launch_plan(p.rlen, p.clen, lanes, strips())
    key = torch.from_numpy(plan.key).pin_memory().to(dev, non_blocking=True)
    order = torch.argsort(key).to(torch.int32)
    nref = p.ref.numel()
    # a band's bottom row per column: 2 buffers x 5 int32 a ref base
    scratch = torch.empty(10 * nref if (plan.bands > 1).any() else 1,
                          dtype=torch.int32, device=dev)
    _, sides, (fork, join), lock = _fork(dev)

    def launch():
        with lock:
            rc = getattr(_lib(), entry)(
                p.read.data_ptr(), p.read_off.data_ptr(), p.ref.data_ptr(),
                p.ref_off.data_ptr(), p.term.data_ptr(), order.data_ptr(),
                plan.counts.ctypes.data_as(ctypes.c_void_p), n, nref,
                scratch.data_ptr(), out.data_ptr(), dev.index,
                torch.cuda.current_stream(dev).cuda_stream, sides,
                fork.cuda_event, join.cuda_event)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc} at launch")
    return out, launch


def ssw_forward_small(p: Pairs) -> torch.Tensor:
    """Forward scores int32 [4, n] of a batch of fits() pairs: a warp per
    pair.  Kernel: ribbit_ssw_forward_small, one launch per strip bucket
    that holds pairs; `launches` counts the calls that launch, not the
    buckets."""
    if not _kernel_device(p):
        return ssw_forward_ref(p)
    out, launch = prepare(p, SMALL_LANES, "ribbit_ssw_forward_small")
    if p.n:
        launch()
        count_launch(ssw_forward_small)
    return out


ssw_forward_small.launches = 0


def ssw_forward_large(p: Pairs) -> torch.Tensor:
    """Forward scores int32 [4, n] of a batch of pairs of any length: a
    block of 8 warps per pair.  Kernel: ribbit_ssw_forward_large, one launch
    per strip bucket that holds pairs; `launches` counts the calls that
    launch, not the buckets."""
    if not _kernel_device(p):
        return ssw_forward_ref(p)
    out, launch = prepare(p, LARGE_LANES, "ribbit_ssw_forward_large")
    if p.n:
        launch()
        count_launch(ssw_forward_large)
    return out


ssw_forward_large.launches = 0


def forward_pairs(kernel, p: Pairs, device) -> np.ndarray:
    """int32 [4, n] (score, end_ref, end_read, first_hit) on the host of a
    batch through one kernel wrapper, the pairs moved to `device` first
    if they lie elsewhere."""
    device = torch.device(device)
    if p.read.device != device:
        require_cuda(device)
        p = Pairs(*(t.to(device) for t in p[:5]), p.rlen, p.clen)
    return kernel(p).cpu().numpy()


def forward(kernel, reads, refs, terms=None, device="cuda"):
    """(score, end_ref, end_read, first_hit) numpy int arrays [n] of a list
    batch through one kernel wrapper: the contract of
    ribbit_tpu.align_pallas.batch_forward."""
    out = forward_pairs(kernel, pack_pairs(reads, refs, terms, device),
                        device)
    return out[0], out[1], out[2], out[3]
