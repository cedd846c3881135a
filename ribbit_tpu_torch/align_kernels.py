"""SSW forward scoring of device-batched refinement: two CUDA kernels and
their plain PyTorch version.

Counterpart of ribbit_tpu/align_pallas_v3.py and ribbit_tpu/align_pallas.py
(whose modules import jax).  Both compute the exact forward pass of
SSW (ribbit_tpu/align.py ssw_align) for a batch of (read, ref) pairs of codes 0-4 and return
int32 [4, n]: score, end_ref, end_read and first_hit (the first column
whose max equals the pair's terminate target, in terminate mode; else -1).

  ssw_forward_small  replaces align_pallas_v3._fwd_kernel (one pair per
                     lane): one thread per pair, for pairs within fits().
  ssw_forward_large  replaces align_pallas._fwd_kernel (reads on lanes,
                     prefix-max F): one block per pair, any length.

Pairs travel ragged (Pairs: codes concatenated with int64 offsets), with
no padding to the batch maximum; the Pallas kernels' padded layouts were a
Mosaic constraint, not part of the contract.  Splitting a batch by fits()
is the caller's work (refine_batched._batch_forward_split), as in the JAX
package.  The kernels live in csrc/ssw_forward.cu, whose header says what
bounds them on an H100.  Each wrapper runs the plain version
(ssw_forward_ref) for CPU tensors only; for a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .backend import require_cuda

GAP_O = 3
GAP_E = 1
WORD_MAX = 32767
RB = 8                   # fits(): rows are counted in blocks of 8
MAX_ROWS = 2560          # fits(): 3R + C cap of the one-pair-per-lane class
# rows whose H and E (8 B a row) fit the large kernel's dynamic shared
# memory: 227 KiB a block on Hopper, less 1 KiB for its static arrays
SMEM_ROWS = (232448 - 1024) // 8


def fits(max_read_len: int, max_ref_len: int) -> bool:
    """True for pairs of the one-pair-per-lane class (a copy of
    ribbit_tpu.align_pallas_v3.fits, whose VMEM budget defines it)."""
    R = RB * max(1, -(-max_read_len // RB))
    C = 8 * max(1, -(-max_ref_len // 8))
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
    require_cuda(device)
    read, read_off, rlen = _concat(reads, n)
    ref, ref_off, clen = _concat(refs, n)
    term = np.full(n, -1, np.int32)
    if terms is not None:
        term[:] = [-1 if t is None else t for t in terms]
    to = lambda a: torch.from_numpy(a).to(device)
    return Pairs(to(read), to(read_off), to(ref), to(ref_off), to(term),
                 rlen, clen)


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
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/ssw_forward.cu, built at first use (raises if nvcc fails)."""
    from .cuda_build import load
    lib = load("ssw_forward")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ribbit_ssw_forward_small.restype = I
    lib.ribbit_ssw_forward_small.argtypes = [P, P, P, P, P, P, I, P, P, P, P,
                                             I, P]
    lib.ribbit_ssw_forward_large.restype = I
    lib.ribbit_ssw_forward_large.argtypes = [P, P, P, P, P, P, I, I, P, P, P,
                                             I, P]
    return lib


def _order(p: Pairs) -> torch.Tensor:
    """Pairs by cells, largest first (int32 on the pairs' device): a warp
    of the small kernel or a wave of the large one gets pairs alike in
    size, and the largest pairs start first."""
    order = np.argsort(-(p.rlen * p.clen), kind="stable").astype(np.int32)
    return torch.from_numpy(order).to(p.read.device)


def _launch_args(p: Pairs):
    return (p.read.data_ptr(), p.read_off.data_ptr(), p.ref.data_ptr(),
            p.ref_off.data_ptr(), p.term.data_ptr())


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def ssw_forward_small(p: Pairs) -> torch.Tensor:
    """Forward scores int32 [4, n] of a batch of fits() pairs.  Kernel:
    ribbit_ssw_forward_small."""
    if not _kernel_device(p):
        return ssw_forward_ref(p)
    dev, n = p.read.device, p.n
    out = torch.empty(4, n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    R = max(int(p.rlen.max()), 1)
    H = torch.empty(R * n, dtype=torch.int32, device=dev)
    E = torch.empty_like(H)
    rd = torch.empty(R * n, dtype=torch.uint8, device=dev)
    order = _order(p)
    rc = _lib().ribbit_ssw_forward_small(
        *_launch_args(p), order.data_ptr(), n, H.data_ptr(),
        E.data_ptr(), rd.data_ptr(), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ssw_forward_small")
    ssw_forward_small.launches += 1
    return out


ssw_forward_small.launches = 0


def ssw_forward_large(p: Pairs) -> torch.Tensor:
    """Forward scores int32 [4, n] of a batch of pairs of any length.
    Kernel: ribbit_ssw_forward_large."""
    if not _kernel_device(p):
        return ssw_forward_ref(p)
    dev, n = p.read.device, p.n
    out = torch.empty(4, n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    in_smem = p.rlen <= SMEM_ROWS
    smem_rows = int(p.rlen[in_smem].max(initial=0))
    # pairs past shared memory keep H and E at their read offsets
    scratch = p.read.numel() if not in_smem.all() else 1
    Hg = torch.empty(scratch, dtype=torch.int32, device=dev)
    Eg = torch.empty_like(Hg)
    order = _order(p)
    rc = _lib().ribbit_ssw_forward_large(
        *_launch_args(p), order.data_ptr(), n, smem_rows,
        Hg.data_ptr(), Eg.data_ptr(), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ssw_forward_large")
    ssw_forward_large.launches += 1
    return out


ssw_forward_large.launches = 0


def forward(kernel, reads, refs, terms=None, device="cuda"):
    """(score, end_ref, end_read, first_hit) numpy int arrays [n] of a list
    batch through one kernel wrapper: the contract of
    ribbit_tpu.align_pallas.batch_forward."""
    out = kernel(pack_pairs(reads, refs, terms, device)).cpu().numpy()
    return out[0], out[1], out[2], out[3]
