"""What decides `correct`: the timed path's outputs held against the plain
reference (benchmarks/ribbitref), which imports nothing of the program.

Two numbers, each exact (limit 0), on the records the run samples from its
seed among those the window delivered:

  events_mismatch  the event streams the timed path replayed for a sampled
                   record (device extraction, D2H, C decode and, on a
                   multi-segment contig, the stitching), against the
                   reference's streams of the whole record computed in one
                   piece: the (stream, motif) pairs whose events differ.
                   The timed path keeps only a 64-bit digest and a count
                   per pair, taken as the streams leave
                   scan_events_segmented, so the check costs the window
                   no memory.
  bed_mismatch     the BED lines the timed path delivered for a sampled
                   record, against the reference's lines of its first
                   prefix_bp bp: the lines that differ (or 1 where only
                   the order does).  The reference runs on the prefix and
                   PAD bp more, and the lines that start in the prefix are
                   compared: the lines that start there depend on nothing
                   after the pad.

The reference's lines come from the sequence alone (replay and refinement
of its own), so bed_mismatch covers every layer up to the BED text on the
prefix; events_mismatch covers the extraction and stitching of the whole
record.
"""

from __future__ import annotations

import collections
import functools
import os
import random

import numpy as np

PAD = 16_384        # bp past the prefix; the longest repeat is ~5.1 kb

_K1 = np.uint64(0x9E3779B97F4A7C15)     # odd: a changed start or end
_K2 = np.uint64(0xC2B2AE3D27D4EB4F)     # always changes the sum


def digests(streams) -> np.ndarray:
    """uint64 [3, nmotifs, 2]: (event count, digest) of every (stream,
    motif) pair of (perfect, q7, q6) streams; the digest is the wrapping
    sum of start * K1 + end * K2 over the pair's events (three passes over
    the arrays: it runs inside the window, on one record)."""
    out = []
    for starts, ends, offsets in streams:
        off = np.asarray(offsets, dtype=np.int64)
        n = int(off[-1])
        with np.errstate(over="ignore"):
            x = np.asarray(starts[:n], dtype=np.int64).view(np.uint64) * _K1
            x += np.asarray(ends[:n], dtype=np.int64).view(np.uint64) * _K2
            cs = np.cumsum(x)
            upto = cs[np.maximum(off - 1, 0)] if n else np.zeros_like(off)
            upto = np.where(off > 0, upto, 0).astype(np.uint64)
            dig = upto[1:] - upto[:-1]
        out.append(np.stack([np.diff(off).astype(np.uint64), dig], axis=1))
    return np.stack(out)


def sample(traffic: dict, seed: int) -> list:
    """Record indices (0 is the warm-up) the check takes, drawn from the
    seed among traffic["check"]["from"] (both ends in): records that every
    window delivers.  The run waits for them past the window if need be."""
    c = traffic["check"]
    lo, hi = c["from"]
    pool = list(range(lo, hi + 1))
    rng = random.Random(seed * 7919 + 17)
    return sorted(rng.sample(pool, min(int(c["records"]), len(pool))))


class Capture:
    """Digests of the streams that scan_events_segmented returns, for the
    calls whose index is in `wanted` (call k is record k: the pipeline
    extracts the records in file order, one call each)."""

    def __init__(self, wanted):
        self.wanted = set(wanted)
        self.calls = 0
        self.got: dict = {}
        self._undo = None

    def install(self, pipeline_module) -> None:
        orig = pipeline_module.scan_events_segmented

        @functools.wraps(orig)
        def captured(*args, **kwargs):
            out = orig(*args, **kwargs)
            k = self.calls
            self.calls += 1
            if k in self.wanted:
                self.got[k] = digests(out)
            return out

        pipeline_module.scan_events_segmented = captured
        self._undo = (pipeline_module, orig)

    def uninstall(self) -> None:
        if self._undo:
            mod, orig = self._undo
            mod.scan_events_segmented = orig
            self._undo = None


def events_mismatch(program: np.ndarray, reference: np.ndarray) -> int:
    return int(np.any(program != reference, axis=2).sum())


def bed_mismatch(program: list, reference: list) -> int:
    if program == reference:
        return 0
    diff = collections.Counter(program)
    diff.subtract(collections.Counter(reference))
    n = sum(abs(v) for v in diff.values())
    return n if n else 1


def prefix_lines(lines: list, prefix: int) -> list:
    return [l for l in lines if int(l.split("\t", 2)[1]) < prefix]


def reference_check(rec, seq: str, program_digest, program_lines: list,
                    ref_cfg, prefix_bp: int, device,
                    workers: int = 0) -> dict:
    """The two numbers for one sampled record; program_digest None (a
    route that does not extract on the device) compares no events."""
    from ribbitref import engine, streams
    from ribbitref.encode import encode
    code, n_mask = encode(seq)
    ref_digest = digests(streams.event_streams(code, n_mask, ref_cfg,
                                               device=device))
    del code, n_mask
    prefix = min(prefix_bp, len(seq))
    hi = min(len(seq), prefix + PAD)
    if hi == len(seq):
        prefix = hi
    ref_lines = engine.process_sequence(
        rec.name, seq[:hi], ref_cfg,
        workers=workers or os.cpu_count() or 1)
    if hi < len(seq):
        ref_lines = prefix_lines(ref_lines, prefix)
        program_lines = prefix_lines(program_lines, prefix)
    return {"events_mismatch": (0 if program_digest is None else
                                events_mismatch(program_digest, ref_digest)),
            "bed_mismatch": bed_mismatch(program_lines, ref_lines),
            "prefix_bp": prefix, "lines": len(ref_lines)}
