"""Exact segment-wise event extraction: halo windows + event stitching.

The device event extractor (scan_events.scan_events_device) produces,
for one sequence, the three compact event streams the native core replays
(perfect runs, threshold-7 window runs, threshold-6 overlay runs; see
csrc/ribbit_core.c).  Whole-contig extraction
materializes O(NSHIFTS * L) intermediates on the device, which caps contig
length by HBM; this module removes the cap by extracting events per
SEGMENT and stitching the per-segment streams into the exact whole-contig
streams.

Exactness argument (the reason no N-run split points are needed, unlike
pipeline._choose_splits): every per-position mask value the extractor
computes has a bounded dependency cone in the sequence —

  eq[s][p]        depends on code[p], code[p+s], s <= max_shift (~102)
                  (fasta_utils.cpp:120-122)
  anchors[s][p]   additionally on the run containing p; anchor runs are
                  < 2*max_shift long and run-length saturation at 256
                  decides longer runs as non-anchors, so the cone is
                  +-(256 + max_shift) (parse_anchored_shiftxor.cpp:20-56)
  qual7/qual6[p]  window [p, p+8) of the above (window_length=8)
  perfect ps/pe   run-length tests saturate at >= 128 >= every cutoff
                  (parse_perfect_shiftxor.cpp:193: max cutoff = m <= 100)

so with HALO >= 512 every mask value inside a segment's core interval is
identical to the whole-contig value.  Runs are then reconstructed exactly:
each segment emits its mask-runs clipped to its core interval, and
adjacent segments' fragments that touch at a core boundary are merged.
For the length-filtered perfect stream, a globally-qualifying run whose
fragment intersects a core always has observed (in-window) length
>= min(true_length, HALO) >= cutoff, so the kernel-level filter already
keeps exactly the right fragments.

The stitched streams are bit-identical to whole-contig extraction
(tests/test_eventstitch.py), which makes BOTH the long-contig single-chip
device path and the distributed chunk path byte-exact: events are gathered
globally and the order-dependent scanner/lattice replay runs ONCE per
contig (O(events)), eliminating the chunk-local replay divergence through
the reference's positional-index vote quirk
(parse_anchored_shiftxor.cpp:441-526).

The port's copy of ribbit_tpu/eventstitch.py, which it may not import.
`extractor` is a required argument here: the JAX package's default
extractor is a jax module.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import tracing
from .config import RibbitConfig
from .core import overlay_cache_max
from .scan_events import EventStreams, overlay_row_words

# minimum exact halo is ~512 (see module doc); 2048 adds margin for free
HALO = 2048

Stream = Tuple[np.ndarray, np.ndarray, np.ndarray]   # starts, ends, offsets


def _channels_of(offsets: np.ndarray, n: int) -> np.ndarray:
    """Per-event channel ids from the channel-major offsets vector."""
    nm = offsets.shape[0] - 1
    return np.repeat(np.arange(nm, dtype=np.int64), np.diff(offsets))[:n]


def clip_stream(stream: Stream, lo: int, hi: int, base: int) -> Tuple[
        np.ndarray, np.ndarray, np.ndarray]:
    """Clip one segment's stream (window-local coordinates, window starts
    at global position `base`) to the core interval [lo, hi) and shift to
    global coordinates.  Returns flat (ch, starts, ends) arrays,
    channel-major sorted."""
    s, e, off = stream
    n = s.shape[0]
    ch = _channels_of(off, n)
    gs = s.astype(np.int64) + base
    ge = e.astype(np.int64) + base
    cs = np.maximum(gs, lo)
    ce = np.minimum(ge, hi)
    keep = cs < ce
    return ch[keep], cs[keep], ce[keep]


def merge_clipped(parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                  nmotifs: int) -> Stream:
    """Merge per-segment clipped fragments into the whole-contig stream.

    parts are in segment order over disjoint, increasing cores; within a
    part events are channel-major and position-sorted.  So the stream's
    (channel, start) order is each channel's slices laid end to end in
    part order: they are copied into place by the parts' channel offsets,
    with no sort.  A global run split at a core boundary appears as
    touching fragments (prev.end == next.start on the same channel), and
    fragments are non-overlapping maximal-run pieces, so touching happens
    only at a seam: a slice whose first fragment starts where the
    channel's last written one ends extends it (a run over a whole middle
    core joins across both of its seams).  The parts are only read."""
    cuts = [np.searchsorted(ch, np.arange(nmotifs + 1)) for ch, _, _ in parts]
    n = sum(p[1].shape[0] for p in parts)
    s = np.empty(n, dtype=np.int64)
    e = np.empty(n, dtype=np.int64)
    offsets = np.empty(nmotifs + 1, dtype=np.int64)
    k = 0
    for c in range(nmotifs):
        offsets[c] = k
        for (_, ps, pe), cut in zip(parts, cuts):
            a, z = cut[c], cut[c + 1]
            if a < z and k > offsets[c] and e[k - 1] == ps[a]:
                e[k - 1] = pe[a]
                a += 1
            s[k:k + z - a] = ps[a:z]
            e[k:k + z - a] = pe[a:z]
            k += z - a
    offsets[nmotifs] = k
    return s[:k], e[:k], offsets


def segment_bounds(L: int, seg_size: int) -> List[int]:
    """Core-interval boundaries for segment streaming: [0, ..., L]."""
    if L <= seg_size:
        return [0, L]
    nseg = (L + seg_size - 1) // seg_size
    step = (L + nseg - 1) // nseg
    return list(range(0, L, step)) + [L]


def capture_runs_host(code: np.ndarray, n_mask: np.ndarray,
                      cfg: RibbitConfig, nthreads: int = 0) -> Tuple[
                          Stream, Stream, Stream]:
    """Host event extractor: the native core's threaded generation pass in
    run-capture mode (csrc/ribbit_core.c ribbit_core_capture_runs).  Same
    contract and bit-identical streams as the device extractors; used as
    the per-chunk extractor for the exact host chunked path."""
    from .core import CoreSession
    sess = CoreSession(code, n_mask, cfg, nthreads=nthreads)
    try:
        return sess.capture_runs()
    finally:
        sess.close()


def place_overlay(out, words, wlo: int, lo: int, hi: int) -> None:
    """Or into `out` (the whole contig's packed overlay, int32 [nmotifs,
    W]; bit j of word g = position 32 g + j) the bits of positions [lo, hi)
    from `words`, a window's packed overlay (bit j of word k = position
    wlo + 32 k + j), on their device.  A window's words fall on the
    contig's grid when wlo is a multiple of 32; otherwise each word is
    funnel-shifted from two."""
    g0, g1 = lo >> 5, (hi + 31) >> 5
    k0, off = divmod(32 * g0 - wlo, 32)       # word g0 from words k0, k0 + 1
    k1 = k0 + g1 - g0 + 1
    u = words[:, max(k0, 0):k1].to(torch.int64) & 0xFFFFFFFF
    left = max(0, -k0)                        # words outside the window: 0
    u = torch.nn.functional.pad(u, (left, k1 - k0 - left - u.shape[1]))
    v = ((u[:, :-1] >> off) | (u[:, 1:] << (32 - off))) & 0xFFFFFFFF
    v[:, 0] &= (0xFFFFFFFF << (lo - 32 * g0)) & 0xFFFFFFFF
    if hi & 31:
        v[:, -1] &= (1 << (hi & 31)) - 1
    v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    out[:, g0:g1] |= v


def scan_events_segmented(code: np.ndarray, n_mask: np.ndarray,
                          cfg: RibbitConfig,
                          extractor: Callable,
                          seg_size: int = 8 << 20,
                          halo: int = HALO) -> EventStreams:
    """Whole-contig event streams via per-segment extraction + stitching.

    `extractor(code, n_mask, cfg) -> (perf, q7, q6)` runs on each halo-
    extended segment.  Output is
    bit-identical to running the extractor on the whole contig, with
    device memory bounded by the segment size, and the contig's packed
    overlay (EventStreams.overlay) besides where the extractor hands each
    segment's on and the C core would cache it (L <= overlay_cache_max()):
    one segment's words as they are, else the segments' core intervals put
    together on their device (place_overlay).  Past the limit each
    segment's words are dropped as soon as it is clipped, and the overlay
    is None.  On 2+ segments, spans "stitch.clip" (a segment's three
    streams, the fragments kept, and its overlay placed) and "stitch.merge"
    (the three merges, the events out, the fragments joined at seams)."""
    L = code.shape[0]
    keep = L <= overlay_cache_max()
    bounds = segment_bounds(L, seg_size)
    if len(bounds) == 2:
        streams = extractor(code, n_mask, cfg)
        return EventStreams(streams, getattr(streams, "overlay", None)
                            if keep else None)

    parts: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = \
        [[], [], []]
    overlay = None
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        wlo, whi = max(0, lo - halo), min(L, hi + halo)
        streams = extractor(np.ascontiguousarray(code[wlo:whi]),
                            np.ascontiguousarray(n_mask[wlo:whi]), cfg)
        with tracing.span("stitch.clip") as sp:
            for j, st in enumerate(streams):
                parts[j].append(clip_stream(st, lo, hi, wlo))
            words = getattr(streams, "overlay", None) if keep else None
            if i == 0 and words is not None:   # extractors are homogeneous
                overlay = words.new_zeros(cfg.nmotifs, overlay_row_words(L))
            if overlay is not None:
                place_overlay(overlay, words, wlo, lo, hi)
            del streams, words         # freed before the next segment
            sp.set(events=sum(p[-1][0].shape[0] for p in parts))
    with tracing.span("stitch.merge") as sp:
        out = tuple(merge_clipped(p, cfg.nmotifs) for p in parts)
        n_out = sum(st[0].shape[0] for st in out)
        sp.set(events=n_out,
               joined=sum(c[1].shape[0] for p in parts for c in p) - n_out)
    return EventStreams(out, overlay)
