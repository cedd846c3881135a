"""Kernel benches of the port on the card, with every input made on the
device.  One JSON line:

    python -m ribbit_tpu_torch.bench_device

Counterpart of ribbit_tpu/bench_device.py (whose module imports jax).

  bench_scan          the full dense generation, anchor_planes + masks
                      (K1 + K5), over every motif channel -> Mbp/s
  bench_events        the event extraction, anchor_planes + event_words
                      (K1 + K2) -> Mbp/s
  bench_event_decode  the host C decoder of event words (csrc/
                      ribbit_events.c) on synthetic words -> Mbp/s on the
                      host, not a device number
  bench_align         ssw_forward_small (K3) on 4096 uniform random pairs,
                      256 x 384 (3R + C = 1152, within fits(): the JAX
                      bench's shapes) -> pairs/s and GCUPS
  run_device_bench    all of them, the int32 probe (bench_roofline) and the
                      roofline shares

Timing: CUDA events around each run after a warm-up, the mean over reps;
each run's output is read (summed) after its end event, outside the time.
The JAX package's marginal two-point method and its dead-code guard are
not carried over, and need not be: they answered XLA, which may merge
identical pure calls (CSE) and drop calls whose output is unread (DCE),
and a ~25 ms dispatch floor over its link.  Eager PyTorch launches every
call it is given and CUDA events time the device itself.

No fallback: with device="cuda" and no CUDA every bench raises.
device="cpu" runs the plain versions at whatever L the caller gives and
reports None for every device number; it serves the tests.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import align_kernels as ak
from . import bench_roofline as br
from . import scan_events as se
from . import scan_masks as sm
from .backend import require_cuda

SEED = 0
CFG = br.CFG
REPS = 5                       # timed runs of the scan and event benches
ALIGN_REPS = 3
PAIRS, READ_LEN, REF_LEN = 4096, 256, 384
DECODE_L = 1 << 22             # the host decoder's bp, at most


def _device(device) -> torch.device:
    require_cuda(device)
    return torch.device(device)


def _timed(fn, consume, reps: int, dev: torch.device):
    """Mean device ms of fn() (bench_roofline.cuda_ms), or None on the CPU
    after one run."""
    if dev.type == "cuda":
        return br.cuda_ms(fn, reps, consume)
    consume(fn())
    return None


def _genome(L: int, dev: torch.device):
    """uint8 code [L] of random bases and an N-free n_mask, made on `dev`
    from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    code = torch.randint(0, 4, (L,), generator=g, dtype=torch.uint8,
                         device=dev)
    return code, torch.zeros(L, dtype=torch.uint8, device=dev)


def _mbps(L: int, ms):
    return None if ms is None else L / (ms * 1e3)


def bench_scan(L: int = 8 << 20, device="cuda") -> dict:
    """Dense generation (K1 + K5) over every motif channel, Mbp/s."""
    dev = _device(device)
    code, n_mask = _genome(L, dev)
    ms = _timed(lambda: sm.masks(code, n_mask, se.anchor_planes(code, CFG),
                                 CFG),
                lambda planes: sum(p.sum() for p in planes), REPS, dev)
    return {"gpu_scan_mbps": _mbps(L, ms), "gpu_scan_channels": CFG.nmotifs}


def bench_events(L: int = 8 << 20, device="cuda") -> dict:
    """Event extraction (K1 + K2, the packed overlay stored as the
    pipeline stores it) over every motif channel, Mbp/s."""
    dev = _device(device)
    code, n_mask = _genome(L, dev)
    ov = torch.empty(CFG.nmotifs, se.overlay_row_words(L), dtype=torch.int32,
                     device=dev)
    ms = _timed(lambda: se.event_words(code, n_mask,
                                       se.anchor_planes(code, CFG), CFG,
                                       overlay=ov),
                lambda w: w.sum(), REPS, dev)
    return {"gpu_event_mbps": _mbps(L, ms)}


def bench_event_decode(L: int = DECODE_L) -> dict:
    """Host C decode of event words, Mbp/s on this host, on synthetic
    words at a chromosome's run density (~0.0052 q6 and 0.00013 q7 runs
    per bp per row, mean run ~60 bp): the recipe of
    ribbit_tpu/bench_device.py's bench_event_decode."""
    ngroups = se.nsp_of(CFG) // se.OUT_ROWS
    rng = np.random.default_rng(SEED)
    w = np.zeros((ngroups, L), dtype=np.uint32)
    meanlen = 60
    # non-touching runs per row: sorted distinct starts, geometric lengths
    # cut at the next start
    for dens, field in ((0.0052, 0), (0.00013, 1)):
        n = int(dens * L)
        for g in range(ngroups):
            for r in range(se.OUT_ROWS):
                s = np.sort(rng.choice(L - meanlen * 2, size=n,
                                       replace=False))
                ln = rng.geometric(1.0 / meanlen, size=n)
                e = np.minimum(s + ln, np.concatenate([s[1:], [L]]))
                e = np.maximum(e, s + 1)
                delta = np.zeros(L + 1, dtype=np.int32)
                np.add.at(delta, s, 1)
                np.add.at(delta, e, -1)
                bm = np.cumsum(delta[:L]) > 0
                w[g] |= (bm.astype(np.uint32)
                         << np.uint32(se._bit_of(r, field)))
    w = w.view(np.int32)
    se._decode_c(w, CFG)                   # warm: library and threads
    best = float("inf")
    for _ in range(4):                     # page faults swing single calls
        t0 = time.perf_counter()
        se._decode_c(w, CFG)
        best = min(best, time.perf_counter() - t0)
    return {"host_decode_mbps": L / 1e6 / best}


def bench_align(device="cuda") -> dict:
    """ssw_forward_small on PAIRS random pairs of READ_LEN x REF_LEN cells,
    pairs/s and GCUPS."""
    B, R, C = PAIRS, READ_LEN, REF_LEN
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    read = torch.randint(0, 4, (B * R,), generator=g, dtype=torch.uint8,
                         device=dev)
    ref = torch.randint(0, 4, (B * C,), generator=g, dtype=torch.uint8,
                        device=dev)
    off = torch.arange(B + 1, dtype=torch.int64, device=dev)
    pairs = ak.Pairs(read, off * R, ref, off * C,
                     torch.full((B,), -1, dtype=torch.int32, device=dev),
                     np.full(B, R, np.int64), np.full(B, C, np.int64))
    ms = _timed(lambda: ak.ssw_forward_small(pairs), lambda o: o[0].sum(),
                ALIGN_REPS, dev)
    return {"gpu_align_pairs_per_s": None if ms is None else B / ms * 1e3,
            "gpu_align_gcups": None if ms is None else B * R * C / ms / 1e6}


def run_device_bench(device="cuda", L: int = 8 << 20) -> dict:
    """Every bench, the int32 probe and the roofline shares, as one dict.
    The card's name and power limit are under "device" ("cpu" for a run of
    the plain versions, whose device numbers are None)."""
    dev = _device(device)
    cuda = dev.type == "cuda"
    out = {"device": br.card_name() if cuda else "cpu"}
    out.update(bench_scan(L=L, device=dev))
    out.update(bench_events(L=L, device=dev))
    out.update(bench_event_decode(L=min(L, DECODE_L)))
    out.update(bench_align(device=dev))
    out["int32_alu_tops"] = br.int32_ceiling(dev) if cuda else None
    out["int32_spec_tops"] = br.spec_int32_rate(dev) / 1e12 if cuda else None
    out.update(br.roofline(out, L))
    return out


if __name__ == "__main__":
    print(json.dumps(run_device_bench()))
