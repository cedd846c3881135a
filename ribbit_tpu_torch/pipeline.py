"""End-to-end pipeline of the port: events extracted on the GPU, replayed
and refined by the C core, or refined with SSW scoring on the GPU.

Counterpart of the device branches of ribbit_tpu/pipeline.py (the
`scan_backend="tpu"` route of _process_core and the multi-contig
producer/consumer loop _fasta_records_tpu_overlap).  Per contig:

  encode -> scan_events_segmented (8 Mi-bp segments + halo, each through
  scan_events.scan_events_device on `device`) -> CoreSession.set_events
  and set_overlay (the event pass's packed overlay, kept on `device` until
  then) -> scan -> refine in the C pool -> BED lines

With RIBBIT_BATCHED_REFINE set (any non-empty value), the refine step is
refine_batched instead: the C round entries build each round's requests,
the SSW forward and terminate passes run as batches through the CUDA
kernels on `device` (align_kernels), the traceback, cigar processing and
emission run in C on the host; records are then processed one at a time
rather than through the overlap loop, as ribbit_tpu/pipeline.py:448-465
does.  Deviation from the JAX package: there a single-contig
`--backend tpu` run takes the batched route even without the variable
(ribbit_tpu/pipeline.py:115).  The port does not, because in a fresh
run the route refines no faster than the C pool: on an H100 80GB HBM3
at 700.00 W (chip_smoke.py --route-abba 20, 40 runs a side),
process_sequence on a 1,031,571 bp contig took 1.0399 s by the median
with the route against 1.0490 s without, and its refinement step
0.2606 s against 0.2578 s (the route faster in 23 of 40 pairs); on
chr21 (46.7 Mb, chip_smoke.py phase 6) the route refined in 10.58 s
against the C pool's 11.48 s.

With engine="python" (ribbit_tpu/pipeline.py:144-204 with
scan_backend="tpu"), a contig runs through the Python engine instead:

  encode -> scan_dense.scan_arrays on `device` (eq_sum8 and anchor_planes
  kernels, torch ops for the overlay and windows, one copy of five
  [nshifts, L] arrays to the host) -> scanner replays and lattices ->
  three-pointer merge -> process_seed / process_seed_motifwise -> BED lines

host._process_python runs it, on the calling thread, contigs one at a
time; it holds about 510 B/bp on the host at the default config.

`--backend host` and, for the core engine, contigs of MAX_CONTIG bp or
more go to the port's host route (host.py).  There is no fallback: a
device, build or launch failure raises.

The multi-device and multi-host routes (parallel/, the counterpart of
ribbit_tpu/parallel/) extract each chunk through scan_events_device as
this module's segments do.  Two deviations from the JAX package there:
no pow2 event-capacity autotune (ribbit_tpu/parallel/distributed.py:40,
67-114; jnp.nonzero needs a static size, the C decode grows its own
buffers), and no pow2 length bucket or dummy all-N rows for the chunk
windows (:50-52; XLA's static shapes), so the windows stay ragged.
"""

from __future__ import annotations

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from . import host as host_pipeline
from . import scan_dense, tracing
from .config import RibbitConfig
from .core import MAX_CONTIG, CoreSession
from .encode import encode
from .eventstitch import scan_events_segmented
from .fasta import read_fasta
from .host import batched_refine_requested, check_engine
from .scan_events import scan_events_device

SEG_SIZE = 8 << 20   # bp per device segment (eventstitch's default)
PREFETCH = 2         # contigs extracted ahead of the one being refined


def extract_events(code, n_mask, cfg: RibbitConfig, device="cuda",
                   seg_size: int = SEG_SIZE):
    """(perfect, q7, q6) event streams of one contig, extracted on
    `device` segment by segment and stitched exactly, with the contig's
    packed overlay on `device` where the C core would cache it
    (scan_events_segmented)."""
    return scan_events_segmented(
        code, n_mask, cfg,
        extractor=functools.partial(scan_events_device, device=device),
        seg_size=seg_size)


def _replay_refine(sid: str, seq: str, code, n_mask, events,
                   cfg: RibbitConfig, nthreads: int,
                   device=None) -> List[str]:
    """Replay the events in the C core, with their packed overlay as its
    overlay cache where they carry one, then refine the seeds in the C
    pool, or with refine_batched on `device` when one is given."""
    sess = CoreSession(code, n_mask, cfg, nthreads=nthreads)
    try:
        sess.set_events(*events)
        if events.overlay is not None:
            sess.set_overlay(events.overlay)
        seeds = sess.scan()
        if device is None:
            return sess.refine(seeds, seq, sid)
        from .refine_batched import refine_batched
        return refine_batched(seeds, seq, sid, code, n_mask, sess, cfg,
                              device=device)
    finally:
        sess.close()


def _over_cap(sid: str, seq: str, cfg: RibbitConfig, device) -> List[str]:
    print(f"ribbit-tpu-torch: {sid} ({len(seq)} bp) is past the native "
          "core's 2^31-64 bp range; processing it on the host's chunked "
          "path", file=sys.stderr)
    return host_pipeline.process_sequence(sid, seq, cfg, device=device)


def process_sequence(sequence_id: str, sequence: str, cfg: RibbitConfig,
                     out: Optional[List[str]] = None,
                     scan_backend: str = "gpu", device="cuda",
                     nthreads: int = 0, engine: str = "core") -> List[str]:
    """BED lines of one sequence (11 tab-separated columns); engine is
    "core" (the C core) or "python" (the Python engine)."""
    check_engine(engine)
    lines: List[str] = out if out is not None else []
    if not sequence:
        return lines
    if scan_backend == "host":
        return host_pipeline.process_sequence(sequence_id, sequence, cfg,
                                              out=lines, nthreads=nthreads,
                                              device=device, engine=engine)
    if scan_backend != "gpu":
        raise ValueError(f"unknown scan backend {scan_backend!r}")
    if engine == "python":
        host_pipeline._process_python(
            sequence_id, sequence, cfg, lines.append,
            functools.partial(scan_dense.scan_arrays, device=device))
        return lines
    if len(sequence) >= MAX_CONTIG:
        lines.extend(_over_cap(sequence_id, sequence, cfg, device))
        return lines
    with tracing.span("pipeline.encode", bp=len(sequence)):
        code, n_mask = encode(sequence)
    events = extract_events(code, n_mask, cfg, device)
    lines.extend(_replay_refine(
        sequence_id, sequence, code, n_mask, events, cfg, nthreads,
        device if batched_refine_requested() else None))
    return lines


def process_fasta_records(path: str, cfg: RibbitConfig,
                          scan_backend: str = "gpu", device="cuda",
                          workers: Optional[int] = None,
                          chunk_size: Optional[int] = None,
                          skip=None, engine: str = "core"):
    """Stream (name, length, lines) per FASTA record, in file order;
    records named in `skip` yield (name, length, None).

    `workers` and `chunk_size` apply to 'host', whose records go to
    host.py as it takes them; 'gpu' bounds device memory by its fixed
    segment size instead, plus the packed overlay (nmotifs / 8 B/bp, 12.4
    at the defaults) of each contig in flight that the C core caches
    (core.overlay_cache_max(), 256 Mi bp by default): up to PREFETCH + 2
    contigs, 13.3 GB at most at the defaults.  The Python engine takes
    the records one at a time.  On 'gpu' each record's work is a "record" span (its bp) serving
    the record's index (tracing.serving)."""
    check_engine(engine)
    if scan_backend == "host":
        yield from host_pipeline.process_fasta_records(
            path, cfg, workers, chunk_size, skip, device=device,
            engine=engine)
        return
    if scan_backend != "gpu":
        raise ValueError(f"unknown scan backend {scan_backend!r}")
    records = list(read_fasta(path))
    todo = [(i, sid, seq) for i, (sid, seq) in enumerate(records)
            if not (skip and sid in skip)]
    if len(todo) > 1 and engine == "core" and not batched_refine_requested():
        yield from _fasta_records_overlap(records, todo, cfg, device)
        return
    for i, (sid, seq) in enumerate(records):
        if skip and sid in skip:
            yield sid, len(seq), None
            continue
        with tracing.serving(i), tracing.span("record", bp=len(seq)):
            lines = process_sequence(sid, seq, cfg, device=device,
                                     engine=engine)
        yield sid, len(seq), lines


def _fasta_records_overlap(records, todo, cfg: RibbitConfig, device):
    """One thread drives the device (extraction of contig k+1 runs while
    the host replays and refines contig k on all cores); at most PREFETCH
    contigs' events are held beyond the one being refined.  Output order
    and bytes match the serial path: the events are identical and the
    replay is per contig.  The device thread is named
    tracing.DEVICE_THREAD; the consumer's wait on it is the span
    "pipeline.wait", inside the record's "record" span."""
    ncpu = os.cpu_count() or 1

    def extract(rec):
        i, _sid, seq = rec
        if not seq or len(seq) >= MAX_CONTIG:
            return None
        with tracing.serving(i):
            with tracing.span("pipeline.encode", bp=len(seq)):
                code, n_mask = encode(seq)
            return code, n_mask, extract_events(code, n_mask, cfg, device)

    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix=tracing.DEVICE_THREAD) as dev:
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
                with tracing.serving(i), tracing.span("record",
                                                      bp=len(seq)):
                    with tracing.span("pipeline.wait"):
                        res = f.result()
                    consumed += 1
                    top_up()
                    if not seq:
                        lines = []
                    elif res is None:
                        lines = _over_cap(sid, seq, cfg, device)
                    else:
                        code, n_mask, events = res
                        lines = _replay_refine(sid, seq, code, n_mask,
                                               events, cfg, ncpu)
                yield sid, len(seq), lines
        finally:
            for f in futs.values():      # a failed run stops extracting
                f.cancel()


def process_fasta(path: str, cfg: RibbitConfig, scan_backend: str = "gpu",
                  device="cuda", workers: Optional[int] = None,
                  chunk_size: Optional[int] = None,
                  engine: str = "core") -> List[str]:
    """Whole-FASTA convenience wrapper: flat BED line list in file order."""
    lines: List[str] = []
    for _sid, _n, r in process_fasta_records(path, cfg, scan_backend, device,
                                             workers, chunk_size,
                                             engine=engine):
        if r:
            lines.extend(r)
    return lines
