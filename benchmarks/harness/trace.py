"""The device trace of a traced run (torch.profiler, CUPTI): what ran on
the card inside the window, and what the host was doing around it.

The window's edges are two empty profiler ranges, "bench::window_open"
and "bench::window_close", that the host places as it opens and closes
the window, on the thread that started the profiler.  They tie the host's
clock to the trace's: the harness's spans, taken on every thread (the
profiler records ranges only on its own), are laid onto the trace by the
line through the two pairs (attach).  Device activity is every kernel,
copy and memset; a kernel belongs to a span when the runtime call that
launched it lies inside that span.
"""

from __future__ import annotations

import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OPEN, CLOSE = "bench::window_open", "bench::window_close"


@dataclasses.dataclass
class Trace:
    lo: float                 # window, trace clock (us)
    hi: float
    device: list              # (name, cat, start, end, correlation)
    launches: dict            # correlation -> launch time (us)
    ranges: list = dataclasses.field(default_factory=list)
    # (target:n, start, end) of the harness's spans, on the trace clock

    def attach(self, span_list, t_open: float, t_close: float) -> None:
        """Lay the harness's spans (perf_counter seconds) onto the trace:
        t_open and t_close are the host times of the two window marks."""
        k = (self.hi - self.lo) / (t_close - t_open)
        self.ranges = [(f"{t}:{n}", self.lo + (a - t_open) * k,
                        self.lo + (b - t_open) * k)
                       for t, _th, a, b, n in span_list]

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
        named by the innermost span covering its middle ("pipeline" where
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
            cover = [(e - s, n) for n, s, e in self.ranges if s <= mid < e]
            name = min(cover)[1].rsplit(":", 1)[0] if cover else "pipeline"
            out.append([name, (b - a) * 1e-6])
        return out

    def kernel_seconds_in(self, target: str) -> tuple:
        """(device seconds of the kernels launched inside `target`'s spans
        that start in the window, the first array lengths of those
        spans)."""
        rs = [(s, e, int(n.rsplit(":", 1)[1])) for n, s, e in self.ranges
              if n.rsplit(":", 1)[0] == target and self.lo <= s < self.hi]
        secs = 0.0
        for _n, cat, a, b, c in self.device:
            if cat != "kernel":
                continue
            t = self.launches.get(c)
            if t is not None and any(s <= t < e for s, e, _l in rs):
                secs += (b - a) * 1e-6
        return secs, [l for _s, _e, l in rs]


def parse(path: str) -> Trace | None:
    """The window's part of an exported chrome trace, or None when the
    trace holds no window marks."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    marks: dict = {}
    device, launches = [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        cat = ev.get("cat", "")
        ts = float(ev["ts"])
        dur = float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name in (OPEN, CLOSE):
            marks[name] = ts
        elif cat in DEVICE_CATS:
            device.append((name, cat, ts, ts + dur,
                           ev.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            c = ev.get("args", {}).get("correlation")
            if c is not None:
                launches[c] = ts
    if OPEN not in marks or CLOSE not in marks:
        return None
    lo, hi = marks[OPEN], marks[CLOSE]
    inside = [(n, k, max(a, lo), min(b, hi), c) for n, k, a, b, c in device
              if b > lo and a < hi]
    return Trace(lo, hi, inside, launches)
