"""Multi-host distributed contig processing over torch.distributed.

Counterpart of ribbit_tpu/parallel/multihost.py, whose module imports jax.
Every process joins one gloo process group (ensure_initialized).  Per
contig, each process owns a contiguous block of the halo-extended chunk
windows and extracts their events with the event kernels on its own
devices (make_mesh(): every local CUDA device by default); the clipped
per-chunk event fragments are all-gathered; every process stitches the
SAME exact whole-contig streams and replays the order-dependent scanner
and lattice core once (redundantly, by design); refinement fans out by
seed slice, and the output lines are all-gathered in rank order.  The
payloads are host arrays, so gloo carries them on any machine.

Output is byte-identical to the single-process run.  Launch (one command
per process; each process reads the same FASTA, and only process 0
writes output):

    python -m ribbit_tpu_torch.cli -i g.fa -o out.bed \\
        --coordinator host0:8476 --num-processes 2 --process-id {0,1}
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import pipeline
from ..config import RibbitConfig
from ..core import MAX_CONTIG, CoreSession
from ..encode import encode
from ..eventstitch import merge_clipped, segment_bounds
from .distributed import (_clip_chunk, _sharded_extract, _stack_windows,
                          distributed_process_contig)
from .sharded_scan import blocks, make_mesh


def ensure_initialized(coordinator: str, num_processes: int,
                       process_id: int) -> None:
    """Join the gloo process group at tcp://coordinator (host:port) as
    rank process_id of num_processes; a second call does nothing."""
    if dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group once every process is done with it: a
    barrier, then each process destroys its group.  (A process that exits
    with the group alive can abort in gloo's teardown.)"""
    if dist.is_initialized():
        _with_deadline(dist.barrier, what="final barrier")
        dist.destroy_process_group()


def _with_deadline(fn, *args, what: str = "collective"):
    """fn(*args), under a watchdog when RIBBIT_COLLECTIVE_TIMEOUT=<seconds>
    is set: a dead or stalled peer leaves a collective blocked forever, and
    the watchdog turns that hang into a TimeoutError that names the stalled
    step and points at --resume (elastic recovery is out of scope)."""
    t = float(os.environ.get("RIBBIT_COLLECTIVE_TIMEOUT", "0") or 0)
    if t <= 0:
        return fn(*args)
    # a DAEMON thread, not a ThreadPoolExecutor: concurrent.futures' atexit
    # hook joins its workers, so an abandoned stalled one would hang the
    # process again at interpreter exit
    q: queue.Queue = queue.Queue(maxsize=1)

    def run():
        try:
            q.put((True, fn(*args)))
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            q.put((False, e))

    threading.Thread(target=run, daemon=True, name=f"ribbit-{what}").start()
    try:
        ok, val = q.get(timeout=t)
    except queue.Empty:
        raise TimeoutError(
            f"multihost {what} exceeded RIBBIT_COLLECTIVE_TIMEOUT={t:g}s — "
            "a peer process is stalled or dead; relaunch the same command "
            "with --resume to continue from the last recorded contig"
        ) from None
    if not ok:
        raise val
    return val


# cumulative all-gathered payload bytes this process has seen (the sum of
# every slot's blob, as the JAX package counts it)
COMM_BYTES = 0


def _all_gather(t: torch.Tensor, what: str) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    _with_deadline(dist.all_gather, out, t, what=what)
    return out


def _gather_blobs(local: dict, total: int) -> List[bytes]:
    """All-gather per-slot byte blobs across processes: `local` maps slot
    index -> bytes for the slots this process owns (disjoint across
    processes).  The slot lengths go first, then each process's blobs
    concatenated in slot order and padded to the longest process's
    (gloo's all_gather wants equal sizes).  Every process gets the same
    list of `total` blobs in slot order."""
    lens = torch.zeros(total, dtype=torch.int64)
    for i, b in local.items():
        lens[i] = len(b)
    per_rank = _all_gather(lens, "length allgather")
    sizes = [int(r.sum()) for r in per_rank]

    global COMM_BYTES
    COMM_BYTES += sum(sizes)
    mine = np.zeros(max(max(sizes), 1), dtype=np.uint8)
    off = 0
    for i in sorted(local):
        b = local[i]
        mine[off:off + len(b)] = np.frombuffer(b, dtype=np.uint8)
        off += len(b)
    payloads = _all_gather(torch.from_numpy(mine), "payload allgather")

    blobs = [b""] * total
    for slot_lens, payload in zip(per_rank, payloads):
        data = payload.numpy()
        off = 0
        for i in np.flatnonzero(slot_lens.numpy()):
            n = int(slot_lens[i])
            blobs[i] = data[off:off + n].tobytes()
            off += n
    return blobs


def _pack_clipped(ch: np.ndarray, s: np.ndarray, e: np.ndarray) -> bytes:
    return np.concatenate([ch, s, e]).astype("<i8").tobytes()


def _unpack_clipped(blob: bytes):
    a = np.frombuffer(blob, dtype="<i8")
    n = a.shape[0] // 3
    return a[:n], a[n:2 * n], a[2 * n:]


def multihost_process_contig(sequence_id: str, sequence: str,
                             cfg: RibbitConfig,
                             chunk_size: int = 8 << 20,
                             workers: Optional[int] = None,
                             timing: bool = False,
                             devices: Optional[Sequence] = None
                             ) -> List[str]:
    """BED lines of one contig, processed cooperatively by every process
    of the group, each extracting on its local `devices` (make_mesh(devices=
    devices)).  Every process must call this with the same arguments (the
    chunk plan and the collective schedule derive from them); each gets the
    full ordered line list."""
    devices = make_mesh(devices=devices)
    L = len(sequence)
    if L >= MAX_CONTIG:
        # the exact global replay needs a whole-contig native session; past
        # the cap every process runs the over-cap route redundantly
        # (deterministic, so all ranks agree)
        print(f"ribbit-tpu-torch: {sequence_id} exceeds 2^31-64 bp; "
              "multihost replay unavailable — every process runs the "
              "over-cap route redundantly", file=sys.stderr)
        return pipeline._over_cap(sequence_id, sequence, cfg, devices[0])
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    if nproc == 1:
        return distributed_process_contig(sequence_id, sequence, cfg,
                                          chunk_size=chunk_size,
                                          workers=workers, devices=devices)
    bounds = segment_bounds(L, chunk_size)
    nchunks = len(bounds) - 1
    if nchunks <= 1:
        # a one-chunk contig: every process computes it redundantly
        return pipeline.process_sequence(sequence_id, sequence, cfg,
                                         device=devices[0],
                                         nthreads=workers or 0)

    t0 = time.perf_counter()
    pid = dist.get_rank()
    code, n_mask = encode(sequence)
    windows, chunks = _stack_windows(code, n_mask, bounds)
    owned = blocks(nchunks, nproc)[pid]
    streams = _sharded_extract(devices, cfg, [chunks[i] for i in owned])
    t_scan = time.perf_counter() - t0

    # clip the owned chunks to their cores and all-gather the fragments
    # (3 slots a chunk); every process then stitches the same streams
    local = {}
    for k, i in enumerate(owned):
        for j, clipped in enumerate(_clip_chunk(streams[k], bounds, windows,
                                                i)):
            local[3 * i + j] = _pack_clipped(*clipped)
    del streams
    blobs = _gather_blobs(local, 3 * nchunks)
    perf, q7, q6 = (merge_clipped([_unpack_clipped(blobs[3 * i + j])
                                   for i in range(nchunks)], cfg.nmotifs)
                    for j in range(3))
    del blobs
    t_events = time.perf_counter() - t0 - t_scan

    # the exact global replay, on every process; refinement by contiguous
    # seed slice (per-seed output is independent, so the slices' lines
    # concatenate to the whole run's)
    sess = CoreSession(code, n_mask, cfg,
                       nthreads=workers or os.cpu_count() or 1)
    try:
        sess.set_events(perf, q7, q6)
        seeds = sess.scan()
        n = seeds.shape[0]
        lines = sess.refine(seeds[pid * n // nproc:(pid + 1) * n // nproc],
                            sequence, sequence_id)
    finally:
        sess.close()
    t_replay = time.perf_counter() - t0 - t_scan - t_events

    blob = ("\n".join(lines) + "\n" if lines else "").encode()
    out_blobs = _gather_blobs({pid: blob}, nproc)
    t_gather = time.perf_counter() - t0 - t_scan - t_events - t_replay
    if timing:
        print(f"[p{pid}] {sequence_id}: {len(owned)}/{nchunks} chunks  "
              f"scan {t_scan:.2f}s  events {t_events:.2f}s  "
              f"replay+refine {t_replay:.2f}s  gather {t_gather:.2f}s  "
              f"comm {COMM_BYTES / 1e6:.1f}MB", file=sys.stderr)

    out: List[str] = []
    for b in out_blobs:
        if b:
            out.extend(b.decode().split("\n")[:-1])
    return out
