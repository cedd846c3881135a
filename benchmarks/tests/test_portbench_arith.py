"""The arithmetic from spans, windows and traces to metrics."""

import json
import threading

import pytest

from harness import main, roofline, spans, spec, trace

SE, SEG = "pipeline.scan_events_device", "pipeline.scan_events_segmented"
SET, SCAN, REF = ("core.CoreSession.set_events", "core.CoreSession.scan",
                  "core.CoreSession.refine")


def test_union_and_clip():
    assert spans.union([]) == 0
    assert spans.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert spans.union([(0, 10), (2, 3)]) == 10
    got = spans.clip([("a", 1, -1.0, 1.0, 0), ("a", 1, 2.0, 3.0, 0),
                      ("a", 1, 9.0, 12.0, 0)], 0.0, 10.0)
    assert got == [("a", 1, 0.0, 1.0, 0), ("a", 1, 2.0, 3.0, 0),
                   ("a", 1, 9.0, 10.0, 0)]


def test_self_time_subtracts_children_on_the_same_thread():
    s = [(SE, 7, 1.0, 2.0, 5), (SE, 7, 3.0, 4.5, 5), (SEG, 7, 0.5, 5.0, 9),
         (SE, 8, 0.6, 4.0, 5)]       # another thread's call is no child
    secs, most = spans.self_seconds(s, SEG, SE)
    assert secs == pytest.approx(4.5 - 2.5) and most == 2


def _view(span_list, mbp=2.0, lo=0.0, hi=10.0, main_thread=7, tr=None):
    return main.RunView(lo, hi, mbp, span_list, main_thread, tr,
                        {"min_motif": 2, "max_motif": 100})


def test_readers_on_spans():
    s = [(SE, 8, 1.0, 2.0, 100), (SE, 8, 3.0, 4.0, 100),
         (SEG, 8, 0.5, 4.5, 200),
         (SET, 7, 2.0, 3.0, 0), (SCAN, 7, 3.0, 5.0, 0), (REF, 7, 5.0, 9.0, 0),
         (REF, 7, 9.5, 12.0, 0)]     # clipped at the window's end
    v = _view(s)
    read = {n: spec.metric_reader(n).read(v) for n in (
        "extract_s_per_mbp", "stitch_s_per_mbp", "replay_s_per_mbp",
        "refine_s_per_mbp", "pipeline_other_s_per_mbp", "extract_roofline",
        "device_idle_share")}
    assert read["extract_s_per_mbp"] == pytest.approx(1.0)
    assert read["stitch_s_per_mbp"] == pytest.approx((4.0 - 2.0) / 2)
    assert read["replay_s_per_mbp"] == pytest.approx(1.5)
    assert read["refine_s_per_mbp"] == pytest.approx((4.0 + 0.5) / 2)
    # main thread busy 2..9 and 9.5..10: 7.5 of 10 s
    assert read["pipeline_other_s_per_mbp"] == pytest.approx(2.5 / 2)
    assert read["extract_roofline"] is None
    assert read["device_idle_share"] is None
    # one segment a call: nothing stitched, nothing to read
    one = [(SE, 8, 1.0, 2.0, 100), (SEG, 8, 0.9, 2.1, 100)]
    assert spec.metric_reader("stitch_s_per_mbp").read(_view(one)) is None


def _trace_file(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _call(target, tid, ts, dur, n):
    return {**X(trace.call_range(target, n), "user_annotation", ts, dur),
            "tid": tid}


def _launch(tid, ts, corr, name="cudaLaunchKernel"):
    return {**X(name, "cuda_runtime", ts, 5, correlation=corr), "tid": tid}


def test_trace_window_busy_gaps_and_roofline(tmp_path):
    """The calls' ranges and the launches on the trace's clock (us), each
    on its thread: a kernel counts for the extractor when its launch lies
    in an extractor call's range on the same thread, whole, where that
    call starts in the window."""
    L = 8392704
    ev = [X("bench::window_open", "user_annotation", 1000, 0),
          X("bench::window_close", "user_annotation", 11000, 0),
          _call(SE, 8, 2000, 3000, L), _call(REF, 7, 5000, 6000, 0),
          _call(SE, 8, 10500, 1000, L),      # starts in the window
          _call(SE, 8, 400, 500, L),         # starts before it
          _launch(8, 2100, 1), _launch(8, 2200, 2),
          _launch(8, 2300, 4, "cudaMemcpyAsync"),
          _launch(7, 2500, 5),               # inside in time, another thread
          _launch(7, 6000, 3), _launch(8, 10600, 6), _launch(8, 500, 7),
          X("anchor_planes_kernel", "kernel", 2150, 200, correlation=1),
          X("event_words_kernel", "kernel", 2400, 300, correlation=2),
          X("consumer_kernel", "kernel", 4500, 50, correlation=5),
          X("other_kernel", "kernel", 6100, 100, correlation=3),
          X("late_kernel", "kernel", 10900, 400, correlation=6),
          X("before_kernel", "kernel", 600, 100, correlation=7),
          X("Memcpy DtoH", "gpu_memcpy", 2700, 1300, correlation=4),
          X("early", "kernel", 0, 1500)]       # 500 us inside the window
    tr = trace.parse(_trace_file(tmp_path, ev))
    assert tr.window_s == pytest.approx(0.010)
    busy = 500 + 200 + 300 + 1300 + 50 + 100 + 100
    assert tr.busy_s() == pytest.approx(busy * 1e-6)
    secs, lengths = tr.kernel_seconds_in(SE)      # kernels, not copies
    assert secs == pytest.approx(900e-6) and lengths == [L, L]
    v = _view([], tr=tr)
    share = spec.metric_reader("extract_roofline").read(v)
    floor = roofline.extract_floor_s(L, 1, 102)
    assert share == pytest.approx(100 * 2 * floor / 900e-6)
    idle = spec.metric_reader("device_idle_share").read(v)
    assert idle == pytest.approx(1 - busy / 10000)
    gaps = tr.gaps()
    assert gaps[0] == ["core.CoreSession.refine", pytest.approx(4.7e-3)]
    assert gaps[1] == ["core.CoreSession.refine", pytest.approx(1.55e-3)]
    assert gaps[2] == ["pipeline", pytest.approx(0.65e-3)]
    assert tr.ops()[0] == ["Memcpy DtoH", pytest.approx(1.3e-3)]
    assert trace.parse(_trace_file(tmp_path, ev[2:])) is None


def test_roofline_ties_launches_that_lead_the_host_span(tmp_path):
    """Launches 0.45 ms ahead of their call's host span as the line
    through the two window marks lays it (host 100.0 s is trace 1000 us,
    host 100.01 s 11000 us): that tie dropped the first two calls' kernels
    and read 3x the share; the calls' own ranges tie all of them."""
    L = 8392704
    ev = [X("bench::window_open", "user_annotation", 1000, 0),
          X("bench::window_close", "user_annotation", 11000, 0)]
    host = []
    corr = 0
    for start, lead in ((2000, 50), (4000, 100), (6000, 500)):
        ev.append(_call(SE, 8, start, 600, L))
        host.append((SE, 8, 100.0 + (start + 450 - 1000) * 1e-6,
                     100.0 + (start + 600 - 1000) * 1e-6, L))
        for t, dur in ((start + lead, 170), (start + lead + 40, 280)):
            corr += 1
            ev += [_launch(8, t, corr),
                   X("k", "kernel", t + 10, dur, correlation=corr)]
    tr = trace.parse(_trace_file(tmp_path, ev))
    floor = roofline.extract_floor_s(L, 1, 102)
    true = 100 * 3 * floor / (3 * 450e-6)
    assert true == pytest.approx(44.8, abs=0.1)
    got = spec.metric_reader("extract_roofline").read(_view(host, tr=tr))
    assert got == pytest.approx(true)
    # the parent's tie: host spans laid by the line through the marks
    laid = [(tr.lo + (a - 100.0) * 1e6, tr.lo + (b - 100.0) * 1e6)
            for _t, _th, a, b, _n in host]
    kept = sum((b - a) * 1e-6 for c, (a, b) in tr.kernels.items()
               if any(s <= tr.launches[c][1] < e for s, e in laid))
    assert kept == pytest.approx(450e-6)
    old = 100 * 3 * floor / kept
    assert old == pytest.approx(3 * true) and old > 105


def test_the_wrapper_opens_a_range_on_the_calling_thread(tmp_path,
                                                         monkeypatch):
    """A wrapped call on another thread, under the traced run's profiler,
    reaches the trace as its range on that thread, with its length."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from torch.profiler import record_function

    from ribbit_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "scan_events_device",
                        lambda code: torch.ones(3) + 1)
    rec = spans.Recorder()
    assert rec.wrap(SE)
    prof = main.profiler("cpu")
    prof.start()
    with record_function(trace.OPEN):
        pass
    with ThreadPoolExecutor(1) as ex:
        tid = ex.submit(lambda: (pipeline.scan_events_device(
            np.zeros(77, np.uint8)), threading.get_native_id())).result()[1]
    with record_function(trace.CLOSE):
        pass
    prof.stop()
    rec.unwrap()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    tr = trace.parse(path)
    assert [(t, th, n) for t, th, _a, _b, n in tr.ranges] == [(SE, tid, 77)]
    assert [s[0] for s in rec.spans] == [SE]
    assert not hasattr(pipeline.scan_events_device, "__wrapped__")


def test_roofline_counts_are_frozen():
    """K1 115.4 MB and K2 560.2 MB per 8,392,704-bp segment at the default
    config, as bench_roofline.py counts them; 0.2017 ms of floor."""
    work = roofline.extract_work(8392704, 1, 102)
    assert work == [(115399680, 856055808), (560212992, 3491364864)]
    assert roofline.extract_floor_s(8392704, 1, 102) == pytest.approx(
        0.20167542e-3, rel=1e-6)
    assert roofline.nsp_of(2, 39) == 40
