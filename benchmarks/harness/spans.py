"""Spans taken by the benchmark's own wrappers around the program's
attributes, and the arithmetic the per-layer readers do on them.

A target names an attribute of the port's package ribbit_tpu_torch as
"<module>.<attr>[.<attr>]", e.g. "pipeline.scan_events_device" or
"core.CoreSession.scan": the wrapper replaces that attribute, so every
call the pipeline makes through it, on any thread, is timed, with the
length of its first array argument (the bp an extractor call covers).  A
target that does not resolve is reported and left out; its metrics then
read nothing.  Each call is also a profiler range on its thread
(trace.call_range), which ties it to its kernels on the trace's clock.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time

PACKAGE = "ribbit_tpu_torch"


def resolve(target: str):
    """(owner, attribute name) of a target, or None."""
    mod_name, *attrs = target.split(".")
    if not attrs:
        return None
    try:
        owner = importlib.import_module(f"{PACKAGE}.{mod_name}")
    except ImportError:
        return None
    for a in attrs[:-1]:
        owner = getattr(owner, a, None)
        if owner is None:
            return None
    if not hasattr(owner, attrs[-1]):
        return None
    return owner, attrs[-1]


def _arg_len(args) -> int:
    for a in args:
        if hasattr(a, "shape") and getattr(a, "ndim", 0) == 1:
            return int(a.shape[0])
    return 0


class Recorder:
    """Spans (target, thread ident, start, end, first array length) in the
    order they close, on the perf_counter clock."""

    def __init__(self):
        self.spans: list = []
        self._undo: list = []
        self._wrapped: set = set()

    def wrap(self, target: str) -> bool:
        """Time every call of `target`; False if it does not resolve."""
        if target in self._wrapped:
            return True
        found = resolve(target)
        if found is None:
            return False
        from torch.profiler import record_function

        from .trace import call_range
        owner, attr = found
        orig = getattr(owner, attr)
        spans = self.spans

        @functools.wraps(orig)
        def timed(*args, **kwargs):
            n = _arg_len(args)
            t0 = time.perf_counter()
            try:
                with record_function(call_range(target, n)):
                    return orig(*args, **kwargs)
            finally:
                spans.append((target, threading.get_ident(), t0,
                              time.perf_counter(), n))

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))
        self._wrapped.add(target)
        return True

    def unwrap(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()
        self._wrapped.clear()


def union(intervals) -> float:
    """Seconds covered by a set of (start, end) intervals."""
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def clip(spans, lo: float, hi: float):
    """(target, thread, start, end, n) clipped to [lo, hi], empty ones
    dropped."""
    out = []
    for t, th, a, b, n in spans:
        a2, b2 = max(a, lo), min(b, hi)
        if b2 > a2:
            out.append((t, th, a2, b2, n))
    return out


def self_seconds(spans, parent: str, child: str) -> tuple:
    """(seconds of `parent` spans less the `child` spans that lie inside
    them on the same thread, the most children any parent span had)."""
    total = 0.0
    most = 0
    kids = [s for s in spans if s[0] == child]
    for t, th, a, b, _n in spans:
        if t != parent:
            continue
        inner = [(max(ka, a), min(kb, b)) for _k, kth, ka, kb, _m in kids
                 if kth == th and kb > a and ka < b]
        total += (b - a) - union(inner)
        most = max(most, len(inner))
    return total, most
