"""Chunked shift-XOR scan over a list of devices.

Counterpart of ribbit_tpu/parallel/sharded_scan.py, whose module imports
jax.  There a 1-D jax Mesh spreads chunk rows over its devices with
shard_map and psum-reduces the per-chunk window counts.  Here the mesh is
an explicit list of torch devices (make_mesh), and map_blocks is the
split: items in contiguous blocks over the list, one worker thread per
distinct device, results kept in block order.  A list may repeat a device
or hold "cpu" entries (the tests' stand-in for the JAX package's forced
8-device CPU mesh); a CUDA device runs the kernels, a CPU device their
plain PyTorch versions.

sharded_scan_step runs each chunk through the eq_sum8 kernel (K10, the
function the JAX package's _chunk_scan computes in XLA) on its device and
sums the counts on the first device.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import scan_dense
from .. import scan_events as se
from ..backend import require_cuda
from ..config import WINDOW_BITCOUNT_SUBSTITUTION, WINDOW_LENGTH, \
    RibbitConfig


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices to split work over: every CUDA device by default
    (cuda:0 ... cuda:{count-1}), or the list given, which may repeat a
    device or name the CPU; n_devices takes the first n and raises if
    there are fewer.  CUDA entries carry an index (a bare "cuda" becomes
    the current device) and raise if CUDA is unavailable."""
    if devices is None:
        require_cuda("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            require_cuda(d)
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"make_mesh: {d} is not a device here "
                                 f"({torch.cuda.device_count()} CUDA "
                                 "devices)")
        elif d.type != "cpu":
            raise ValueError(f"make_mesh: unsupported device {d}")
        out.append(d)
    if n_devices is not None:
        if n_devices > len(out):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(out)} available")
        out = out[:n_devices]
    if not out:
        raise ValueError("make_mesh: no device")
    return out


def _on(device: torch.device):
    """The device as the thread's current CUDA device (torch's current
    device is per thread); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def blocks(n: int, ndev: int) -> List[range]:
    """n items split into ndev contiguous blocks of ceil(n / ndev), as a
    sharded axis splits rows (the last blocks may be short or empty)."""
    per = max(1, -(-n // ndev))
    return [range(min(k * per, n), min((k + 1) * per, n))
            for k in range(ndev)]


def map_blocks(devices: Sequence[torch.device], n: int,
               fn: Callable[[torch.device, range], object]) -> list:
    """[fn(devices[k], block k) for every non-empty block k of n items
    split over the devices], in block order.  One worker thread per
    distinct device runs that device's blocks in order, inside its device
    context; with one distinct device the calling thread runs them.  The
    first failure raises."""
    bs = blocks(n, len(devices))
    work: dict = {}
    for k, r in enumerate(bs):
        if len(r):
            work.setdefault(devices[k], []).append(k)
    out: dict = {}

    def run(device, ks):
        with _on(device):
            for k in ks:
                out[k] = fn(device, bs[k])

    if len(work) <= 1:
        for device, ks in work.items():
            run(device, ks)
    else:
        with ThreadPoolExecutor(len(work),
                                thread_name_prefix="ribbit-dev") as ex:
            for f in [ex.submit(run, d, ks) for d, ks in work.items()]:
                f.result()
    return [out[k] for k in sorted(out)]


def map_items(devices: Sequence[torch.device], n: int,
              fn: Callable[[torch.device, int], object]) -> list:
    """[fn(device of item i, i) for i < n], by item index, the items split
    as map_blocks splits them."""
    return [x for part in map_blocks(
        devices, n, lambda d, r: [fn(d, i) for i in r]) for x in part]


def _chunk_scan(code: torch.Tensor, n_mask: torch.Tensor,
                cfg: RibbitConfig):
    """One chunk on its device: uint8 code and n_mask [C] -> (eq bool
    [nshifts, C], qualified-window counts int32 [nshifts]).  eq and the
    8-window sums come from eq_sum8 (zero-padded past C, as _chunk_scan's
    gather is); a window p <= C - 8 qualifies with a sum >= 7 and no N."""
    C = code.shape[0]
    eq, sum8 = scan_dense.eq_sum8(code, cfg)
    nw = max(C - WINDOW_LENGTH + 1, 0)
    nfree = se._win8(n_mask)[:nw] == 0
    qualified = (sum8[:, :nw] >= WINDOW_BITCOUNT_SUBSTITUTION) & nfree
    return eq.view(torch.bool), qualified.sum(dim=1).to(torch.int32)


def sharded_scan_step(devices: Sequence[torch.device], cfg: RibbitConfig):
    """The multi-device step: step(code [B, C], n_mask [B, C]) -> (eq
    [B, nshifts, C], counts [B, nshifts], total [1]), on devices[0].

    code holds 1-byte codes (N as 0, as encode gives), n_mask is true at
    N; numpy arrays or tensors.  eq[b, r, p] = code[b, p] == code[b, p + s]
    (s = min_shift + r, code reading 0 past the chunk), counts the windows
    p <= C - 8 whose 8-window sum is >= 7 and that hold no N, total their
    sum over every chunk.  Chunk rows split into contiguous blocks over
    the devices; B must divide by their number, as under shard_map."""
    devices = list(devices)

    def step(code, n_mask):
        code, n_mask = (t if isinstance(t, torch.Tensor) else
                        torch.from_numpy(np.ascontiguousarray(t))
                        for t in (code, n_mask))
        if code.dim() != 2 or code.element_size() != 1 \
                or tuple(n_mask.shape) != tuple(code.shape):
            raise ValueError(f"sharded_scan_step: want 1-byte code and an "
                             f"n_mask of one shape [B, C], got "
                             f"{code.dtype} {tuple(code.shape)} and "
                             f"{tuple(n_mask.shape)}")
        B = code.shape[0]
        if B % len(devices):
            raise ValueError(f"sharded_scan_step: {B} chunks do not divide "
                             f"over {len(devices)} devices")
        code = code.contiguous().view(torch.uint8)
        n_mask = n_mask.to(torch.uint8).contiguous()

        def one(device, b):
            return _chunk_scan(code[b].to(device), n_mask[b].to(device),
                               cfg)

        parts = map_items(devices, B, one)
        home = devices[0]
        eq = torch.stack([e.to(home) for e, _ in parts])
        counts = torch.stack([c.to(home) for _, c in parts])
        total = counts.sum(dtype=torch.int64).reshape(1)
        return eq, counts, total

    return step
