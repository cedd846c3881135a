"""The port's merge_clipped (ribbit_tpu_torch.eventstitch), which lays
each part's channel slices end to end and joins fragments only at the
seams, on the CPU: against the lexsort merge it replaced (kept here as the
spec), the JAX package's merge_clipped and the runs the fragments were cut
from, with every numpy sort made to raise while it runs; and
scan_events_segmented over several segments with the host's run capture:
the whole contig's streams, and the stitch.merge span's counts."""

import numpy as np
import pytest

from ribbit_tpu.eventstitch import merge_clipped as jax_merge_clipped
from ribbit_tpu_torch import tracing
from ribbit_tpu_torch.config import RibbitConfig
from ribbit_tpu_torch.encode import encode
from ribbit_tpu_torch.eventstitch import (capture_runs_host, clip_stream,
                                          merge_clipped,
                                          scan_events_segmented,
                                          segment_bounds)
from ribbit_tpu_torch.sim import simulate


def lexsort_merge(parts, nmotifs):
    """The merge by a global sort: concatenate every fragment, order them
    by (channel, start), join touching neighbours anywhere."""
    if not parts:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(nmotifs + 1, dtype=np.int64)
    ch = np.concatenate([p[0] for p in parts])
    s = np.concatenate([p[1] for p in parts])
    e = np.concatenate([p[2] for p in parts])
    order = np.lexsort((s, ch))
    ch, s, e = ch[order], s[order], e[order]
    if s.shape[0]:
        new = np.ones(s.shape[0], dtype=bool)
        new[1:] = (ch[1:] != ch[:-1]) | (s[1:] != e[:-1])
        g = np.flatnonzero(new)
        last = np.append(g[1:], s.shape[0]) - 1
        ch, s, e = ch[g], s[g], e[last]
    offsets = np.searchsorted(ch, np.arange(nmotifs + 1)).astype(np.int64)
    return s, e, offsets


def _runs(rng, L, channels, per_channel):
    """Maximal runs in [0, L): a channel's runs sorted, apart by at least
    one position (2 r distinct sorted bounds paired up)."""
    runs = {}
    for c in channels:
        r = int(rng.integers(0, per_channel + 1))
        b = np.sort(rng.choice(L + 1, size=2 * r, replace=False))
        runs[c] = list(zip(b[0::2].tolist(), b[1::2].tolist()))
    return runs


def _plant(runs, c, lo, hi):
    """Put the run [lo, hi) on channel c, dropping the runs it would
    overlap or touch."""
    keep = [(s, e) for s, e in runs.get(c, []) if e < lo or s > hi]
    runs[c] = sorted(keep + [(lo, hi)])


def _stream(runs, nmotifs):
    """The whole contig's stream (starts, ends, channel offsets)."""
    s, e, counts = [], [], np.zeros(nmotifs, dtype=np.int64)
    for c in range(nmotifs):
        for a, z in runs.get(c, []):
            s.append(a)
            e.append(z)
        counts[c] = len(runs.get(c, []))
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return (np.asarray(s, dtype=np.int64), np.asarray(e, dtype=np.int64),
            off)


def _case(name, nmotifs):
    """(whole stream, core bounds) of a named fixture on a 6,000-bp
    contig."""
    rng = np.random.default_rng([sum(map(ord, name)), nmotifs])
    L = 6000
    nparts = {"two": 2, "three": 3, "five": 5, "middle_core": 3,
              "middle_cores": 5, "empty_parts": 5, "zero": 4}[name]
    bounds = segment_bounds(L, -(-L // nparts))
    assert len(bounds) == nparts + 1
    runs = {}
    if name in ("two", "three", "five", "middle_core", "middle_cores"):
        runs = _runs(rng, L, range(nmotifs), 12)
        # runs that end on a bound, start on one, and cross one
        for k, b in enumerate(bounds[1:-1]):
            _plant(runs, 3 * k, b - 40, b)
            _plant(runs, 3 * k + 1, b, b + 40)
            _plant(runs, 3 * k + 2, b - 17, b + 23)
    if name == "middle_core":          # one run over the whole middle core
        _plant(runs, nmotifs - 1, bounds[1] - 9, bounds[2] + 9)
        _plant(runs, 40, bounds[1], bounds[2])
    if name == "middle_cores":         # over three cores, four seams
        _plant(runs, nmotifs - 1, bounds[1] - 1, bounds[4] + 1)
        _plant(runs, 40, bounds[1] + 5, bounds[3] - 5)
    if name == "empty_parts":
        # parts 1-3 hold nothing; channels 50-60 only the last part
        runs = _runs(rng, bounds[1], range(50), 6)
        for c in range(50, 61):
            runs[c] = [(bounds[4] + 30 * j, bounds[4] + 30 * j + 11)
                       for j in range(1 + c % 3)]
    return _stream(runs, nmotifs), bounds


CASES = [(n, m) for n in ("two", "three", "five", "middle_core",
                          "middle_cores", "empty_parts", "zero")
         for m in (99, 299)]


def _read_only(part):
    """The part as multihost's _unpack_clipped hands it: read-only views
    of one received buffer."""
    a = np.frombuffer(np.concatenate(part).astype("<i8").tobytes(),
                      dtype="<i8")
    n = a.shape[0] // 3
    return a[:n], a[n:2 * n], a[2 * n:]


def _no_sort(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("merge_clipped sorted")
    for name in ("lexsort", "argsort", "sort"):
        monkeypatch.setattr(np, name, refuse)


@pytest.mark.parametrize("frombuffer", [False, True],
                         ids=["arrays", "frombuffer"])
@pytest.mark.parametrize("name,nmotifs", CASES,
                         ids=[f"{n}-{m}" for n, m in CASES])
def test_merge_by_offsets_equals_the_sorted_merge(monkeypatch, name,
                                                  nmotifs, frombuffer):
    whole, bounds = _case(name, nmotifs)
    parts = [clip_stream(whole, lo, hi, 0)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    if frombuffer:
        parts = [_read_only(p) for p in parts]
        assert not parts[0][1].flags.writeable
    before = [tuple(a.copy() for a in p) for p in parts]
    spec = lexsort_merge(parts, nmotifs)
    jax_spec = jax_merge_clipped(parts, nmotifs)
    with monkeypatch.context() as mp:
        _no_sort(mp)
        got = merge_clipped(parts, nmotifs)
    assert got[2].shape == (nmotifs + 1,)
    for g, w, j, h in zip(got, spec, jax_spec, whole):
        assert g.dtype == np.int64 and g.flags.c_contiguous
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, h)
    for p, b in zip(parts, before):
        for a, c in zip(p, b):
            np.testing.assert_array_equal(a, c)
            assert not any(np.shares_memory(a, g) for g in got)
    fragments = sum(p[1].shape[0] for p in parts)
    if name == "zero":
        assert fragments == 0
    elif name == "empty_parts":
        assert all(p[1].shape[0] == 0 for p in parts[1:4])
        assert fragments == got[0].shape[0] > 0
    else:
        # the fixture has runs across seams, so the merge joined some
        assert fragments > got[0].shape[0]


def test_merge_of_no_parts_is_empty():
    s, e, off = merge_clipped([], 99)
    assert s.shape == e.shape == (0,) and s.dtype == e.dtype == np.int64
    np.testing.assert_array_equal(off, np.zeros(100, dtype=np.int64))


@pytest.fixture()
def recorder():
    tracing.reset()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.reset()


@pytest.mark.parametrize("cfg_kw,seg_size", [({}, 7000),
                                             ({"max_motif": 300}, 9000)],
                         ids=["default", "M300"])
def test_segmented_host_capture_equals_the_whole_contig(recorder, cfg_kw,
                                                        seg_size):
    """scan_events_segmented over 3+ segments of a contig under one
    generation tile (64 Ki bp, so the C capture's tile-edge fault cannot
    differ between the whole and the windows) gives the whole contig's
    streams; stitch.merge counts the events out and the fragments joined,
    which are the clips' fragments less the events out."""
    cfg = RibbitConfig.create(**cfg_kw)
    seq = simulate(num_loci=10, seed=23, max_motif=cfg.max_motif,
                   n_block_rate=0.3, name="st").sequence
    code, n_mask = encode(seq)
    assert code.shape[0] < 1 << 16
    nseg = len(segment_bounds(code.shape[0], seg_size)) - 1
    assert nseg >= 3
    whole = capture_runs_host(code, n_mask, cfg)
    got = scan_events_segmented(code, n_mask, cfg, capture_runs_host,
                                seg_size=seg_size)
    for w, g in zip(whole, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(np.asarray(a, dtype=np.int64), b)
    spans = tracing.snapshot()
    clips = [s for s in spans if s.name == "stitch.clip"]
    (merge,) = [s for s in spans if s.name == "stitch.merge"]
    assert len(clips) == nseg
    out = sum(st[0].shape[0] for st in got)
    fragments = sum(s.counts["events"] for s in clips)
    assert merge.counts["events"] == out
    assert merge.counts["joined"] == fragments - out > 0
