"""The device trace of a traced run (torch.profiler, CUPTI): what ran on
the card inside the window, and what the host was doing around it.

Everything here is on the trace's one clock.  The window's edges are two
empty profiler ranges, "bench::window_open" and "bench::window_close",
that the host places as it opens and closes the window.  The harness's
wrappers (spans.Recorder) open a profiler range "bench:<target>:<n>"
around every call they time, on the calling thread, n the length of the
call's first array; the profiler records ranges on every thread
(profile_all_threads, harness/main.py).  Device activity is every kernel,
copy and memset; a kernel belongs to a call when the runtime call that
launched it lies inside the call's range on the same thread.
"""

from __future__ import annotations

import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OPEN, CLOSE = "bench::window_open", "bench::window_close"
CALL = "bench:"                  # prefix of a call's range (spans.Recorder)


def call_range(target: str, n: int) -> str:
    """The profiler range name of one call of `target` over n bp."""
    return f"{CALL}{target}:{n}"


def _call(name: str):
    """(target, n) of a call's range name, or None."""
    parts = name.split(":")
    if len(parts) != 3 or parts[0] + ":" != CALL or not parts[1] or \
            not parts[2].isdigit():
        return None
    return parts[1], int(parts[2])


@dataclasses.dataclass
class Trace:
    lo: float                 # window, trace clock (us)
    hi: float
    device: list              # (name, cat, start, end, correlation), clipped
    kernels: dict             # correlation -> (start, end), whole
    launches: dict            # correlation -> (thread, launch time)
    ranges: list              # (target, thread, start, end, n) of the calls

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy_s(self) -> float:
        from .spans import union
        return union((a, b) for _n, _k, a, b, _c in self.device) * 1e-6

    def ops(self, top: int = 10) -> list:
        tot: dict = {}
        for n, _k, a, b, _c in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a) * 1e-6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:top]

    def gaps(self, top: int = 10) -> list:
        """The longest spans of the window with nothing on the device, each
        named by the innermost call covering its middle ("pipeline" where
        none does)."""
        ivs = sorted((a, b) for _n, _k, a, b, _c in self.device)
        gaps = []
        t = self.lo
        for a, b in ivs + [(self.hi, self.hi)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            cover = [(e - s, t) for t, _th, s, e, _n in self.ranges
                     if s <= mid < e]
            out.append([min(cover)[1] if cover else "pipeline",
                        (b - a) * 1e-6])
        return out

    def kernel_seconds_in(self, target: str) -> tuple:
        """(device seconds, whole, of the kernels launched inside the calls
        of `target` that start in the window, those calls' first array
        lengths)."""
        calls = [(th, s, e, n) for t, th, s, e, n in self.ranges
                 if t == target and self.lo <= s < self.hi]
        secs = 0.0
        for c, (a, b) in self.kernels.items():
            th_t = self.launches.get(c)
            if th_t is not None and any(
                    th == th_t[0] and s <= th_t[1] < e
                    for th, s, e, _n in calls):
                secs += (b - a) * 1e-6
        return secs, [n for _th, _s, _e, n in calls]


def parse(path: str) -> Trace | None:
    """The window's part of an exported chrome trace, or None when the
    trace holds no window marks."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    marks: dict = {}
    device, kernels, launches, ranges = [], {}, {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        cat = ev.get("cat", "")
        ts = float(ev["ts"])
        dur = float(ev.get("dur", 0.0))
        corr = ev.get("args", {}).get("correlation")
        if cat == "user_annotation":
            if name in (OPEN, CLOSE):
                marks[name] = ts
            elif (call := _call(name)) is not None:
                ranges.append((call[0], ev.get("tid"), ts, ts + dur,
                               call[1]))
        elif cat in DEVICE_CATS:
            device.append((name, cat, ts, ts + dur, corr))
            if cat == "kernel" and corr is not None:
                kernels[corr] = (ts, ts + dur)
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = (ev.get("tid"), ts)
    if OPEN not in marks or CLOSE not in marks:
        return None
    lo, hi = marks[OPEN], marks[CLOSE]
    inside = [(n, k, max(a, lo), min(b, hi), c) for n, k, a, b, c in device
              if b > lo and a < hi]
    return Trace(lo, hi, inside, kernels, launches, ranges)
