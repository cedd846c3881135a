"""Distributed contig processing over a list of devices.

Counterpart of ribbit_tpu/parallel/distributed.py, whose module imports
jax.  A long contig splits into halo-extended windows at raw offsets
(eventstitch.segment_bounds; no N-run split points are needed), the
windows split into contiguous blocks over the devices, and each device
extracts its windows' events with the event kernels (K1 anchor_planes and
K2 event_words, then the C decode: scan_events.scan_events_device).  The
per-chunk streams are clipped to their core intervals and stitched into
the exact whole-contig streams, and the order-dependent scanner and
lattice replay runs once, globally, before the C pool refines.  Output is
byte-identical to the single-process run.

What the JAX package needs only for XLA's static shapes is not carried
over: the windows stay ragged (no pow2 length bucket, no dummy all-N rows
padding the chunk count to a device multiple), and the per-chunk event
capacities need no autotune, because the C decode grows its own buffers.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from .. import pipeline
from ..config import RibbitConfig
from ..core import MAX_CONTIG, CoreSession
from ..encode import encode
from ..eventstitch import HALO, clip_stream, merge_clipped, segment_bounds
from ..scan_events import scan_events_device
from .sharded_scan import make_mesh, map_items


def _stack_windows(code: np.ndarray, n_mask: np.ndarray, bounds: List[int],
                   halo: int = HALO):
    """The halo-extended window (lo, hi) = (max(0, b_i - halo),
    min(L, b_{i+1} + halo)) of each chunk, and its code and n_mask."""
    L = code.shape[0]
    windows = [(max(0, bounds[i] - halo), min(L, bounds[i + 1] + halo))
               for i in range(len(bounds) - 1)]
    return windows, [(np.ascontiguousarray(code[a:b]),
                      np.ascontiguousarray(n_mask[a:b]))
                     for a, b in windows]


def _sharded_extract(devices: Sequence, cfg: RibbitConfig, chunks) -> list:
    """(perfect, q7, q6) streams of each (code, n_mask) chunk, extracted
    on its device of the contiguous split; listed by chunk index.  The
    chunks' packed overlays are dropped as each returns: this route's
    replay does not read them."""
    return map_items(
        devices, len(chunks),
        lambda d, i: tuple(scan_events_device(*chunks[i], cfg, device=d)))


def _clip_chunk(streams, bounds: List[int], windows, i: int):
    """Chunk i's three streams clipped to its core [b_i, b_{i+1}), in
    global coordinates: three (ch, starts, ends) triples."""
    return [clip_stream(st, bounds[i], bounds[i + 1], windows[i][0])
            for st in streams]


def distributed_process_contig(sequence_id: str, sequence: str,
                               cfg: RibbitConfig,
                               chunk_size: int = 8 << 20,
                               n_devices: Optional[int] = None,
                               workers: Optional[int] = None,
                               devices: Optional[Sequence] = None
                               ) -> List[str]:
    """BED lines of one contig: events extracted chunk by chunk over the
    devices (make_mesh(n_devices, devices)), then ONE exact global replay
    and the C pool's refinement on `workers` threads (default: every
    core)."""
    devices = make_mesh(n_devices, devices)
    L = len(sequence)
    if L >= MAX_CONTIG:
        # the one global replay needs one whole-contig native session
        print(f"ribbit-tpu-torch: {sequence_id} exceeds 2^31-64 bp; "
              "distributed replay unavailable — using the over-cap route",
              file=sys.stderr)
        return pipeline._over_cap(sequence_id, sequence, cfg, devices[0])
    bounds = segment_bounds(L, chunk_size)
    if len(bounds) - 1 <= 1:
        return pipeline.process_sequence(sequence_id, sequence, cfg,
                                         device=devices[0],
                                         nthreads=workers or 0)
    code, n_mask = encode(sequence)
    windows, chunks = _stack_windows(code, n_mask, bounds)
    streams = _sharded_extract(devices, cfg, chunks)
    del chunks

    parts = [[], [], []]
    for i, st in enumerate(streams):
        for j, clipped in enumerate(_clip_chunk(st, bounds, windows, i)):
            parts[j].append(clipped)
    del streams
    perf, q7, q6 = (merge_clipped(p, cfg.nmotifs) for p in parts)

    sess = CoreSession(code, n_mask, cfg,
                       nthreads=workers or os.cpu_count() or 1)
    try:
        sess.set_events(perf, q7, q6)
        seeds = sess.scan()
        return sess.refine(seeds, sequence, sequence_id)
    finally:
        sess.close()
