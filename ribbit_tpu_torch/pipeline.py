"""End-to-end pipeline of the port: events extracted on the GPU, replayed
and refined by the shared C core.

Counterpart of the device branches of ribbit_tpu/pipeline.py (the
`scan_backend="tpu"` route of _process_core and the multi-contig
producer/consumer loop _fasta_records_tpu_overlap).  Per contig:

  encode -> scan_events_segmented (8 Mi-bp segments + halo, each through
  scan_events.scan_events_device on `device`) -> CoreSession.set_events
  -> scan -> refine -> BED lines

Every contig refines in the shared C pool, as the JAX package's overlap
loop does; its single-contig batched-SSW route (refine_batched, Pallas
kernels K3/K4) is not ported yet.  `--backend host` and contigs of
MAX_CONTIG bp or more go to ribbit_tpu.pipeline, which imports no jax on
those routes.  There is no fallback: a device, build or launch failure
raises.
"""

from __future__ import annotations

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ribbit_tpu import pipeline as host_pipeline
from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.core import MAX_CONTIG, CoreSession
from ribbit_tpu.encode import encode
from ribbit_tpu.eventstitch import scan_events_segmented
from ribbit_tpu.fasta import read_fasta

from .scan_events import scan_events_device

SEG_SIZE = 8 << 20   # bp per device segment (eventstitch's default)
PREFETCH = 2         # contigs extracted ahead of the one being refined


def extract_events(code, n_mask, cfg: RibbitConfig, device="cuda",
                   seg_size: int = SEG_SIZE):
    """(perfect, q7, q6) event streams of one contig, extracted on
    `device` segment by segment and stitched exactly."""
    return scan_events_segmented(
        code, n_mask, cfg,
        extractor=functools.partial(scan_events_device, device=device),
        seg_size=seg_size)


def _replay_refine(sid: str, seq: str, code, n_mask, events,
                   cfg: RibbitConfig, nthreads: int) -> List[str]:
    sess = CoreSession(code, n_mask, cfg, nthreads=nthreads)
    try:
        sess.set_events(*events)
        return sess.refine(sess.scan(), seq, sid)
    finally:
        sess.close()


def _over_cap(sid: str, seq: str, cfg: RibbitConfig) -> List[str]:
    print(f"ribbit-tpu-torch: {sid} ({len(seq)} bp) is past the native "
          "core's 2^31-64 bp range; processing it on the host's chunked "
          "path", file=sys.stderr)
    return host_pipeline.process_sequence(sid, seq, cfg)


def process_sequence(sequence_id: str, sequence: str, cfg: RibbitConfig,
                     out: Optional[List[str]] = None,
                     scan_backend: str = "gpu", device="cuda",
                     nthreads: int = 0) -> List[str]:
    """BED lines of one sequence (11 tab-separated columns)."""
    lines: List[str] = out if out is not None else []
    if not sequence:
        return lines
    if scan_backend == "host":
        return host_pipeline.process_sequence(sequence_id, sequence, cfg,
                                              out=lines, nthreads=nthreads)
    if scan_backend != "gpu":
        raise ValueError(f"unknown scan backend {scan_backend!r}")
    if len(sequence) >= MAX_CONTIG:
        lines.extend(_over_cap(sequence_id, sequence, cfg))
        return lines
    code, n_mask = encode(sequence)
    events = extract_events(code, n_mask, cfg, device)
    lines.extend(_replay_refine(sequence_id, sequence, code, n_mask, events,
                                cfg, nthreads))
    return lines


def process_fasta_records(path: str, cfg: RibbitConfig,
                          scan_backend: str = "gpu", device="cuda",
                          workers: Optional[int] = None,
                          chunk_size: Optional[int] = None,
                          skip=None):
    """Stream (name, length, lines) per FASTA record, in file order;
    records named in `skip` yield (name, length, None).

    `workers` and `chunk_size` apply to 'host', whose records go to
    ribbit_tpu.pipeline as it takes them; 'gpu' bounds device memory by
    its fixed segment size instead."""
    if scan_backend == "host":
        yield from host_pipeline.process_fasta_records(
            path, cfg, "host", "core", workers, chunk_size, skip)
        return
    if scan_backend != "gpu":
        raise ValueError(f"unknown scan backend {scan_backend!r}")
    records = list(read_fasta(path))
    todo = [(i, sid, seq) for i, (sid, seq) in enumerate(records)
            if not (skip and sid in skip)]
    if len(todo) > 1:
        yield from _fasta_records_overlap(records, todo, cfg, device)
        return
    for sid, seq in records:
        skipped = skip and sid in skip
        yield sid, len(seq), (None if skipped else process_sequence(
            sid, seq, cfg, device=device))


def _fasta_records_overlap(records, todo, cfg: RibbitConfig, device):
    """One thread drives the device (extraction of contig k+1 runs while
    the host replays and refines contig k on all cores); at most PREFETCH
    contigs' events are held beyond the one being refined.  Output order
    and bytes match the serial path: the events are identical and the
    replay is per contig."""
    ncpu = os.cpu_count() or 1

    def extract(rec):
        _i, _sid, seq = rec
        if not seq or len(seq) >= MAX_CONTIG:
            return None
        code, n_mask = encode(seq)
        return code, n_mask, extract_events(code, n_mask, cfg, device)

    with ThreadPoolExecutor(max_workers=1) as dev:
        futs = {}
        submitted = consumed = 0

        def top_up():
            nonlocal submitted
            while submitted < len(todo) and submitted - consumed <= PREFETCH:
                t = todo[submitted]
                futs[t[0]] = dev.submit(extract, t)
                submitted += 1

        try:
            top_up()
            for i, (sid, seq) in enumerate(records):
                f = futs.pop(i, None)
                if f is None:
                    yield sid, len(seq), None
                    continue
                res = f.result()
                consumed += 1
                top_up()
                if not seq:
                    yield sid, 0, []
                elif res is None:
                    yield sid, len(seq), _over_cap(sid, seq, cfg)
                else:
                    code, n_mask, events = res
                    yield sid, len(seq), _replay_refine(
                        sid, seq, code, n_mask, events, cfg, ncpu)
        finally:
            for f in futs.values():      # a failed run stops extracting
                f.cancel()


def process_fasta(path: str, cfg: RibbitConfig, scan_backend: str = "gpu",
                  device="cuda", workers: Optional[int] = None,
                  chunk_size: Optional[int] = None) -> List[str]:
    """Whole-FASTA convenience wrapper: flat BED line list in file order."""
    lines: List[str] = []
    for _sid, _n, r in process_fasta_records(path, cfg, scan_backend, device,
                                             workers, chunk_size):
        if r:
            lines.extend(r)
    return lines
