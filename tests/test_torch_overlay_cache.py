"""The event pass's packed overlay as the C core's overlay cache, on the
CPU: the plain version of the words (overlay_words_ref, which the event
pass's CPU path runs) against host generation's cache (ov_pack) bit for
bit, their stitching over segments, the setter (CoreSession.set_overlay)
and what the replay gives with it, its refusals and the cache rule, and
its span."""

import numpy as np
import pytest
import torch

from ribbit_tpu_torch import host, pipeline, tracing
from ribbit_tpu_torch import scan_events as se
from ribbit_tpu_torch.config import RibbitConfig
from ribbit_tpu_torch.core import CoreSession, overlay_cache_max
from ribbit_tpu_torch.encode import encode
from ribbit_tpu_torch.eventstitch import place_overlay, segment_bounds
from ribbit_tpu_torch.sim import simulate

torch.set_num_threads(2)

CFGS = {"default": {}, "m4-M37": {"min_motif": 4, "max_motif": 37},
        "M300": {"max_motif": 300}}


def _contig(seed: int, max_motif: int = 100, loci: int = 5) -> str:
    """A simulated contig with N blocks, its length cut to L % 64 == 37."""
    seq = simulate(num_loci=loci, seed=seed, max_motif=max_motif,
                   n_block_rate=0.5, name="ov").sequence
    return seq[:len(seq) - len(seq) % 64 - 27]


def _cache_rows(sess):
    """The session's overlay cache (ribbit_core_overlay_row, whoever built
    it) as int32 [nmotifs, overlay_row_words(L)], or None without one."""
    nw32 = se.overlay_row_words(sess.code.shape[0])
    rows = [sess.lib.ribbit_core_overlay_row(sess.handle, d)
            for d in range(sess.cfg.nmotifs)]
    if not rows[0]:
        return None
    return np.stack([np.ctypeslib.as_array(r, (nw32,)) for r in rows])


def _host_cache(code, n_mask, cfg) -> np.ndarray:
    """Host generation's ov_pack of the contig, as int32 rows."""
    sess = CoreSession(code, n_mask, cfg)
    try:
        sess.lib.ribbit_core_scan_phase(sess.handle, 0)    # generation
        return _cache_rows(sess)
    finally:
        sess.close()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_reference_words_equal_host_generation_cache(name):
    """overlay_words_ref equals host generation's ov_pack on every motif
    channel (the m = 2 row's lower anchor neighbour is shift 1), N blocks
    and the contig's tail included; bits from L on are 0; event_words
    with an overlay output writes the same words."""
    cfg = RibbitConfig.create(**CFGS[name])
    seq = _contig(5, max_motif=cfg.max_motif)
    code, n_mask = encode(seq)
    L = code.shape[0]
    assert L % 64 and n_mask.any()
    c, n = se.device_inputs(code, n_mask, device="cpu")
    anch = se.anchor_planes(c, cfg)
    ref = se.overlay_words_ref(c, anch, cfg)
    assert ref.shape == (cfg.nmotifs, se.overlay_row_words(L))
    want = _host_cache(code, n_mask, cfg)
    assert want is not None and want.shape == tuple(ref.shape)
    np.testing.assert_array_equal(ref.numpy(), want)
    bits = se.unpack_words(ref, ref.shape[1] * 32)
    assert not bits[:, L:].any() and bits[:, :L].any()
    ov = torch.full_like(ref, -1)
    words = se.event_words(c, n, anch, cfg, overlay=ov)
    assert torch.equal(ov, ref)
    assert torch.equal(words, se.flagwords_ref(c, n, anch, cfg))


def test_event_words_checks_the_overlay_output():
    cfg = RibbitConfig.create()
    code, n_mask = encode("ACGTN" * 40)
    c, n = se.device_inputs(code, n_mask, device="cpu")
    anch = se.anchor_planes(c, cfg)
    good = (cfg.nmotifs, se.overlay_row_words(200))
    for bad in (torch.zeros(good[0] - 1, good[1], dtype=torch.int32),
                torch.zeros(good[0], good[1] - 1, dtype=torch.int32),
                torch.zeros(good, dtype=torch.int64),
                torch.zeros(good[1], good[0], dtype=torch.int32).t(),
                torch.zeros(good, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError):
            se.event_words(c, n, anch, cfg, overlay=bad)


@pytest.mark.parametrize("on_grid, seg_size", [(True, 6144), (False, 7777)])
def test_segmented_overlay_equals_whole_contig(on_grid, seg_size):
    """scan_events_segmented over four segments, their bounds on the
    32-bit word grid (as an hg38 cell's are) or off it, gives the whole
    contig's words."""
    cfg = RibbitConfig.create()
    seq = _contig(8, loci=9)
    code, n_mask = encode(seq[:4 * seg_size] if on_grid else seq)
    bounds = segment_bounds(code.shape[0], seg_size)
    assert len(bounds) == 5
    assert on_grid == all(b % 32 == 0 for b in bounds)
    whole = se.scan_events_device(code, n_mask, cfg, device="cpu")
    seg = pipeline.extract_events(code, n_mask, cfg, device="cpu",
                                  seg_size=seg_size)
    assert seg.overlay is not None and torch.equal(seg.overlay,
                                                   whole.overlay)
    for w, s in zip(whole, seg):
        for a, b in zip(w, s):
            assert np.array_equal(a, b)


def test_stitching_without_overlay_hands_on_none():
    """An extractor that gives no overlay (the host's run capture) leaves
    the streams without one, on one segment and on several."""
    from ribbit_tpu_torch.eventstitch import (capture_runs_host,
                                              scan_events_segmented)
    cfg = RibbitConfig.create()
    code, n_mask = encode(_contig(9))
    for seg_size in (5000, 1 << 20):
        out = scan_events_segmented(code, n_mask, cfg, capture_runs_host,
                                    seg_size=seg_size)
        assert len(out) == 3 and out.overlay is None


@pytest.mark.parametrize("case", range(40))
def test_place_overlay_puts_any_window_on_the_grid(case):
    """place_overlay against a placement bit by bit, at window starts
    and core bounds on and off the word grid, windows that start past the
    core's first word and end at the contig's last word."""
    rng = np.random.default_rng(case)
    L = int(rng.integers(70, 900))
    lo = int(rng.integers(0, L - 1))
    hi = int(rng.integers(lo + 1, L + 1))
    wlo = int(rng.integers(max(0, lo - 70), lo + 1))
    whi = int(rng.integers(hi, L + 1))
    bits = torch.from_numpy(rng.random((3, whi - wlo)) < 0.5)
    words = torch.zeros(3, se.overlay_row_words(whi - wlo), dtype=torch.int32)
    words[:, :(whi - wlo + 31) // 32] = se.pack_words(bits)
    out = torch.zeros(3, se.overlay_row_words(L), dtype=torch.int32)
    out[:, 0] = 1 << 3 if lo > 3 else 0           # bits outside: kept
    want = se.unpack_words(out, L).clone()
    want[:, lo:hi] |= bits[:, lo - wlo:hi - wlo]
    place_overlay(out, words, wlo, lo, hi)
    assert torch.equal(se.unpack_words(out, out.shape[1] * 32)[:, :L], want)
    assert not se.unpack_words(out, out.shape[1] * 32)[:, L:].any()


def _replay(code, n_mask, seq, cfg, events=None, overlay=None):
    """(seed bytes, BED lines, overlay rows filled) of one session: host
    generation without events, else the events injected, with the
    overlay words set when given."""
    sess = CoreSession(code, n_mask, cfg, nthreads=2)
    try:
        rows = None
        if events is not None:
            sess.set_events(*events)
            if overlay is not None:
                rows = sess.set_overlay(overlay)
        seeds = sess.scan()
        return seeds.tobytes(), sess.refine(seeds, seq, "ov"), rows
    finally:
        sess.close()


@pytest.mark.parametrize("name", ["default", "m4-M37"])
def test_setter_gives_the_same_seeds_and_bed(name):
    """Injected events with the overlay set give seeds and BED lines
    byte-identical to injected events without it and to host
    generation."""
    cfg = RibbitConfig.create(**CFGS[name])
    seq = _contig(12, max_motif=cfg.max_motif, loci=10)
    code, n_mask = encode(seq)
    ev = pipeline.extract_events(code, n_mask, cfg, device="cpu")
    with_ov = _replay(code, n_mask, seq, cfg, ev, ev.overlay)
    without = _replay(code, n_mask, seq, cfg, ev)
    hosted = _replay(code, n_mask, seq, cfg)
    assert with_ov[2] == cfg.nmotifs and without[2] is None
    assert with_ov[:2] == without[:2] == hosted[:2]
    assert len(with_ov[1]) > 0
    assert with_ov[1] == host.process_sequence("ov", seq, cfg)


def test_setter_refuses_shapes_and_keeps_the_cache_rule(monkeypatch):
    """A wrong row or word count or dtype raises and leaves no cache; past
    RIBBIT_OVERLAY_CACHE_MAX the setter declines (0 rows, no cache) and
    the replay recomputes, to the same seeds."""
    cfg = RibbitConfig.create()
    seq = _contig(14)
    code, n_mask = encode(seq)
    ev = pipeline.extract_events(code, n_mask, cfg, device="cpu")
    ov = ev.overlay
    sess = CoreSession(code, n_mask, cfg)
    try:
        sess.set_events(*ev)
        assert sess.set_overlay(ov) == cfg.nmotifs
        assert np.array_equal(_cache_rows(sess), ov.numpy())
        for bad in (ov[:-1], ov[:, :-1], ov[:, :-2],
                    torch.cat([ov, ov[:, :2]], 1), ov.to(torch.int64)):
            with pytest.raises(ValueError):
                sess.set_overlay(bad)
            assert _cache_rows(sess) is None
    finally:
        sess.close()
    want = _replay(code, n_mask, seq, cfg, ev)
    monkeypatch.setenv("RIBBIT_OVERLAY_CACHE_MAX", str(code.shape[0] - 1))
    got = _replay(code, n_mask, seq, cfg, ev, ov)
    assert got[2] == 0 and got[:2] == want[:2]
    monkeypatch.setenv("RIBBIT_OVERLAY_CACHE_MAX", str(code.shape[0]))
    assert _replay(code, n_mask, seq, cfg, ev, ov)[2] == cfg.nmotifs


def test_replay_overlay_span_on_both_routes(tmp_path):
    """Every replayed contig, on the overlap loop and on the serial route,
    has one replay.overlay span between set_events and the scan, counting
    the bytes copied and rows = the motif count; the BED lines are the
    host route's."""
    cfg = RibbitConfig.create()
    fa = tmp_path / "three.fa"
    seqs = [_contig(20 + k) for k in range(3)]
    fa.write_text("".join(f">c{k}\n{s}\n" for k, s in enumerate(seqs)))
    one = tmp_path / "one.fa"
    one.write_text(f">c0\n{seqs[0]}\n")
    tracing.reset()
    tracing.enable()
    try:
        for path, n in ((fa, 3), (one, 1)):
            tracing.reset()
            out = list(pipeline.process_fasta_records(str(path), cfg,
                                                      device="cpu"))
            assert [r[2] for r in out] == [
                host.process_sequence(f"c{k}", seqs[k], cfg)
                for k in range(n)]
            spans = tracing.snapshot()
            for k in range(n):
                mine = sorted((s for s in spans if s.record == k
                               and s.name.startswith("replay.")),
                              key=lambda s: s.start_ns)
                names = [s.name for s in mine]
                assert names[:3] == ["replay.set_events", "replay.overlay",
                                     "replay.generate"]
                ov = mine[1]
                words = se.overlay_row_words(len(seqs[k]))
                assert ov.counts == {"bytes": cfg.nmotifs * words * 4,
                                     "rows": cfg.nmotifs}
    finally:
        tracing.disable()
        tracing.reset()


def test_cache_limit_is_read_from_the_core(monkeypatch):
    """overlay_cache_max is the C core's rule: 256 Mi bp, or
    RIBBIT_OVERLAY_CACHE_MAX."""
    monkeypatch.delenv("RIBBIT_OVERLAY_CACHE_MAX", raising=False)
    assert overlay_cache_max() == 256 << 20
    monkeypatch.setenv("RIBBIT_OVERLAY_CACHE_MAX", "12345")
    assert overlay_cache_max() == 12345


@pytest.mark.parametrize("seg_size", [1 << 20, 5000])
def test_extraction_keeps_no_overlay_past_the_cache_limit(monkeypatch,
                                                          seg_size):
    """Past RIBBIT_OVERLAY_CACHE_MAX the extraction keeps no words, on one
    segment and on several, and its streams do not change; at the limit
    it keeps them."""
    cfg = RibbitConfig.create()
    code, n_mask = encode(_contig(15))
    L = code.shape[0]
    monkeypatch.setenv("RIBBIT_OVERLAY_CACHE_MAX", str(L - 1))
    past = pipeline.extract_events(code, n_mask, cfg, device="cpu",
                                   seg_size=seg_size)
    assert past.overlay is None
    monkeypatch.setenv("RIBBIT_OVERLAY_CACHE_MAX", str(L))
    at = pipeline.extract_events(code, n_mask, cfg, device="cpu",
                                 seg_size=seg_size)
    assert at.overlay is not None
    for a, b in zip(past, at):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_one_segment_hands_the_words_on_as_they_are():
    """On one segment the stitching passes the extractor's words on, with
    no copy."""
    from ribbit_tpu_torch.eventstitch import scan_events_segmented
    cfg = RibbitConfig.create()
    code, n_mask = encode(_contig(16))
    made = []

    def extractor(c, n, cfg_):
        made.append(se.scan_events_device(c, n, cfg_, device="cpu"))
        return made[-1]

    out = scan_events_segmented(code, n_mask, cfg, extractor)
    assert len(made) == 1 and out.overlay is made[0].overlay


def test_sharded_extract_drops_the_overlays():
    """The distributed route's chunks carry no overlay past extraction:
    its one replay does not read them."""
    from ribbit_tpu_torch.parallel import distributed
    cfg = RibbitConfig.create()
    code, n_mask = encode(_contig(17))
    chunks = [(code[:3000], n_mask[:3000]), (code[2000:], n_mask[2000:])]
    out = distributed._sharded_extract(distributed.make_mesh(
        devices=["cpu", "cpu"]), cfg, chunks)
    assert [type(st) for st in out] == [tuple, tuple]
    for st, (c, n) in zip(out, chunks):
        want = se.scan_events_device(c, n, cfg, device="cpu")
        for a, b in zip(st, want):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
