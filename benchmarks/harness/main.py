"""One run of one cell: set-up, the measured window, the correctness check
and the result line.

The window drives ribbit_tpu_torch.pipeline.process_fasta_records on the
card, as the port's CLI does, over the files the traffic describes.  It
opens when the first record (the warm-up record) is delivered, that is
when the generator yields its BED lines, and closes at the first delivery
at or after --seconds; every record delivered in between counts, whole.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import sys
import tempfile
import threading
import time

from . import check, spans, spec
from . import traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "ribbit_tpu")


def process_start_wall() -> float:
    """Wall-clock time at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


class RssSampler(threading.Thread):
    """The highest resident set size of this process while it runs."""

    def __init__(self, period: float = 0.02):
        super().__init__(daemon=True)
        self.period = period
        self.peak = 0
        self._halt = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")

    def sample(self) -> None:
        with open("/proc/self/statm") as fh:
            rss = int(fh.read().split()[1]) * self._page
        self.peak = max(self.peak, rss)

    def run(self) -> None:
        while not self._halt.is_set():
            self.sample()
            self._halt.wait(self.period)

    def stop(self) -> int:
        self._halt.set()
        self.join()
        self.sample()
        return self.peak


def forbidden_modules() -> list:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that a run may not load."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reference_imports() -> list:
    """Files of the plain reference that import the program, JAX or the
    JAX package (read from their sources)."""
    import ast
    bad = []
    for path in sorted((spec.BENCH_DIR / "ribbitref").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            if any(n.split(".")[0] in FORBIDDEN + ("ribbit_tpu_torch",)
                   for n in names):
                bad.append(path.name)
    return bad


class RunView:
    """What a per-layer reader reads: the window, the Mbp it delivered, the
    spans clipped to it, and the device trace when there is one."""

    def __init__(self, lo, hi, mbp, span_list, main_thread, trace, flags):
        self.lo, self.hi = lo, hi
        self.window_s = hi - lo
        self.mbp = mbp
        self.spans = spans.clip(span_list, lo, hi)
        self.main_thread = main_thread
        self.trace = trace
        mn, mx = flags.get("min_motif", 2), flags.get("max_motif", 100)
        self.min_shift = mn - 2 if mn > 2 else 1
        self.max_shift = mx + 2

    def seconds(self, *targets) -> float:
        return sum(b - a for t, _th, a, b, _n in self.spans if t in targets)

    def found(self, *targets) -> bool:
        return any(s[0] in targets for s in self.spans)


def _iterate(files, layout, cfg, device, backend):
    from ribbit_tpu_torch import pipeline
    for f in files[:1] if layout == "one_fasta" else files:
        yield from pipeline.process_fasta_records(f, cfg,
                                                  scan_backend=backend,
                                                  device=device)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", root=spec.ROOT, ref_workers: int = 0,
        gen_workers: int = 0, t_script: float | None = None,
        control=None, backend: str = "gpu") -> tuple:
    """(result dict, check lines).  `control`, when given, is called as
    control(record, sequence, digests, lines, ref_cfg, prefix_bp,
    ref_workers) after the window and returns the (digests, lines) that the
    check then holds against the reference in place of the timed path's:
    benchmarks/control.py.  backend="host" runs the port's host route
    instead (benchmarks/host_route.py), whose events are not the device
    extractor's: its events_mismatch is not compared."""
    t_script = time.perf_counter() if t_script is None else t_script
    wall_at_script = time.time() - (time.perf_counter() - t_script)
    started = process_start_wall()
    cell = spec.load_cell(workload, root)
    flags = cell.config["flags"]
    tmp = tempfile.mkdtemp(prefix="ribbit_bench_")
    try:
        records = traffic_mod.plan(cell.config, cell.traffic, seed)
        files = traffic_mod.layout(records, cell.traffic,
                                   pathlib.Path(tmp))
        pool, futs = traffic_mod.start_writing(records, cell.config,
                                               gen_workers)
        try:
            import torch
            from ribbit_tpu_torch import pipeline
            from ribbit_tpu_torch.config import RibbitConfig
            cfg = RibbitConfig.create(**flags)
            wanted = check.sample(cell.traffic, seed)
            capture = check.Capture(wanted)
            recorder = spans.Recorder() if trace else None
            readers = {}
            if trace:
                for m in cell.per_layer:
                    readers[m["name"]] = spec.metric_reader(m["name"], root)
                    for t in readers[m["name"]].TARGETS:
                        if not recorder.wrap(t):
                            print(f"bench: target {t} of {m['name']} not "
                                  "found; it reads nothing", file=sys.stderr)
            capture.install(pipeline)
            for f in futs:
                f.result()
        finally:
            pool.shutdown(wait=True)
        out = _window(cell, files, cfg, device, seconds, trace, wanted,
                      tmp, backend)
        capture.uninstall()
        if recorder:
            recorder.unwrap()
        out["setup_s"] = (out["t_open"] - t_script) + (wall_at_script -
                                                       started)
        mem_peak = (torch.cuda.max_memory_allocated()
                    if torch.device(device).type == "cuda" else 0)
        kind = (torch.cuda.get_device_name(0)
                if torch.device(device).type == "cuda" else "cpu")

        # ---- correctness, after the window, the peak read ----
        from ribbitref.config import RibbitConfig as RefConfig
        ref_cfg = RefConfig.create(**flags)
        nums = {"events_mismatch": 0, "bed_mismatch": 0}
        detail = []
        for k in wanted:
            rec = records[k]
            seq = traffic_mod.sequence(rec, cell.config)
            lines = out["kept"].get(k)
            dig = capture.got.get(k)
            prefix_bp = int(cell.traffic["check"]["prefix_bp"])
            if control is not None:
                dig, lines = control(rec, seq, dig, lines, ref_cfg,
                                     prefix_bp, ref_workers)
            if lines is None or (dig is None and backend == "gpu"):
                nums["bed_mismatch"] += 1
                nums["events_mismatch"] += 1
                continue
            r = check.reference_check(rec, seq, dig, lines, ref_cfg,
                                      prefix_bp, device, ref_workers)
            detail.append({"record": rec.name, **r})
            for key in nums:
                nums[key] += r[key]
        correct = all(v <= 0 for v in nums.values())

        # ---- metrics ----
        lo, hi, mbp = out["t_open"], out["t_close"], out["mbp"]
        e2e = {"mbp_per_s": (mbp / (hi - lo), "Mbp/s"),
               "host_peak_gib": (out["rss_peak"] / 2 ** 30, "GiB"),
               "setup_s": (out["setup_s"], "s")}
        metrics = {}
        if not trace:
            for m in cell.end_to_end:
                v, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            view = RunView(lo, hi, mbp, recorder.spans, out["main_thread"],
                           out["trace"], flags)
            for m in cell.per_layer:
                v = readers[m["name"]].read(view)
                if v is None:
                    print(f"bench: {m['name']} found nothing to read",
                          file=sys.stderr)
                    continue
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
               "memory_peak_bytes": int(mem_peak)}
        result = {"correct": bool(correct), "attempted": out["attempted"],
                  "failed": out["failed"], "metrics": metrics, "device": dev}
        if trace and out["trace"] is not None:
            tr = out["trace"]
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.ops(),
                                   "idle_gaps": tr.gaps()}
            result["traced_end_to_end"] = {
                k: {"value": e2e[k][0], "unit": e2e[k][1]}
                for k in ("mbp_per_s", "host_peak_gib")}
        result["check_detail"] = detail
        result["checks"] = {k: {"value": v, "limit": 0}
                            for k, v in nums.items()}
        lines = [f"check {k} {v} limit 0" for k, v in nums.items()]
        return result, lines
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profiler(device):
    """The traced run's torch.profiler: the host, the card where there is
    one, and ranges on every thread, so that the harness's call ranges on
    the device thread reach the trace (trace.py)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))


def _window(cell, files, cfg, device, seconds, trace, wanted, tmp,
            backend):
    """Drive the entry over the files; returns the window's numbers."""
    import torch
    prof = None
    if trace:
        from torch.profiler import record_function
        prof = profiler(device)
        prof.start()
    rss = RssSampler()
    kept: dict = {}
    t_open = t_close = None
    mbp = 0.0
    attempted = failed = 0
    need = max(wanted) if wanted else 0
    gen = _iterate(files, cell.traffic["layout"], cfg, device, backend)
    idx = -1
    try:
        for idx, (name, n, lines) in enumerate(gen):
            t = time.perf_counter()
            if idx in wanted:
                kept[idx] = lines
            if idx == 0:
                t_open = t
                rss.start()
                if prof:
                    with record_function("bench::window_open"):
                        pass
            elif t_close is None:
                attempted += 1
                failed += lines is None
                mbp += n / 1e6
                if t - t_open >= seconds:
                    t_close = t
                    if prof:
                        with record_function("bench::window_close"):
                            pass
                    rss_peak = rss.stop()
            if t_close is not None and idx >= need:
                break
    finally:
        gen.close()
    if t_close is None:
        print(f"bench: the pass ended inside the window after "
              f"{time.perf_counter() - t_open:.1f} s ({idx} records); a "
              "longer pass is needed", file=sys.stderr)
        t_close = time.perf_counter()
        if prof:
            with record_function("bench::window_close"):
                pass
        rss_peak = rss.stop()
    parsed = None
    if prof:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        from . import trace as trace_mod
        parsed = trace_mod.parse(path)
        if parsed is None or not parsed.device:
            print("bench: the profiler saw no device activity in the window",
                  file=sys.stderr)
    return {"t_open": t_open, "t_close": t_close, "mbp": mbp,
            "attempted": attempted, "failed": failed, "rss_peak": rss_peak,
            "kept": kept, "trace": parsed,
            "main_thread": threading.get_ident()}


def main(argv=None, t_script=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result, lines = run(a.workload, a.seed, a.seconds, bool(a.trace),
                        t_script=t_script)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}; the port may not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    bad = reference_imports()
    if bad:
        print(f"bench: the reference's {bad} import the program or JAX",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
