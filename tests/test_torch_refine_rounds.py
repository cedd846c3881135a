"""The batched refinement route's round entries in C
(ribbit_tpu_torch/csrc/refine_rounds.c, CoreSession.round_requests and
round_emit) against their Python spec, refine_batched._requests and
_emit, element by element and in order, round after round: each
request's context, read and ref bytes; each line, its order key and the
next round's items.  Both sides get the same alignments (the C core's
aligner, pair by pair).  Then the C entries on 1 and 8 threads, the two
forms of the overlay gate on every round-1 item (with the session's
packed overlay and without it), and the route against the JAX package's
refine_batched (Pallas K3/K4 in interpret mode) on g3, and which
refinement a gpu run takes.

Fixtures: g1-g3, a two-contig simulated genome with N runs, a contig at
-m 4 -M 37 and one of 130-300 bp motifs at -M 300 (the m > 128 motif
quirk)."""

import ctypes

import numpy as np
import pytest
import torch

from ribbit_tpu_torch import refine_batched as rb
from ribbit_tpu_torch.align import _ssw_align_native
from ribbit_tpu_torch.config import RibbitConfig
from ribbit_tpu_torch.core import CoreSession
from ribbit_tpu_torch.encode import encode
from ribbit_tpu_torch.fasta import read_fasta
from ribbit_tpu_torch.native import get_align_lib
from ribbit_tpu_torch.sim import simulate

torch.set_num_threads(2)


def _contigs(golden_dir, name):
    """(config, [(name, sequence)]) of a fixture."""
    if name in ("g1", "g2", "g3"):
        return RibbitConfig.create(), list(read_fasta(
            str(golden_dir / f"{name}.fa")))
    if name == "two-contig":
        return RibbitConfig.create(), [
            (f"sim{i}", simulate(num_loci=12, seed=70 + i, n_block_rate=0.5,
                                 name=f"sim{i}").sequence) for i in range(2)]
    if name == "m4-M37":
        return RibbitConfig.create(min_motif=4, max_motif=37), [
            ("sim37", simulate(num_loci=14, seed=11, min_motif=4,
                               max_motif=37, n_block_rate=0.3).sequence)]
    return RibbitConfig.create(max_motif=300), [
        ("sim300", simulate(num_loci=6, seed=3, min_motif=130, max_motif=300,
                            max_units=4, n_block_rate=0.3).sequence)]


FIXTURES = ["g1", "g2", "g3", "two-contig", "m4-M37", "M300"]


def _cigars(aligns):
    """The flat cigar buffer, offsets and lengths of a round's alignments
    (length 0 for none)."""
    text = [al.cigar_string if al is not None else "" for al in aligns]
    lens = np.array([len(t) for t in text], np.int64)
    return ("".join(text).encode("ascii"), np.cumsum(lens) - lens, lens)


def _walk(sid, seq, cfg, stats, nthreads=2):
    """Every round of one contig through the spec and the C entries,
    compared as it goes; returns the spec's (key, line) results."""
    lib = get_align_lib()
    code, n_mask = encode(seq)
    sess = CoreSession(code, n_mask, cfg)
    try:
        seeds = sess.scan()
        translated = rb._translate_codes(seq)
        first, items = rb.first_items(seeds)
        pending = [((int(i),), int(s), int(e), int(m), int(t),
                    cfg.motif_channel(int(m)))
                   for i, s, e, m, t in zip(first, *items)]
        paths = [(int(i),) for i in first]
        results = []
        while pending:
            start, end, mlen, seed_type = items
            want, pairs = rb._requests(pending, translated, code, n_mask,
                                       sess, cfg)
            req = sess.round_requests(translated, start, end, mlen,
                                      mlen - cfg.min_shift,
                                      nthreads=nthreads)
            _same_requests(req, want, pairs, paths, stats)
            _count(sess, pending, req, stats)

            aligns = [_ssw_align_native(r, f, lib) if r.size and f.size
                      else None for r, f in pairs]
            got_lines = []
            next_pending = rb._emit(want, aligns, sid, code, cfg, got_lines)
            results += got_lines
            em = sess.round_emit(req, sid, start, end, mlen, seed_type,
                                 *_cigars(aligns), nthreads=nthreads)
            assert em.lines == [line for _k, line in got_lines]
            keys = [paths[req.item[k]] + ((int(req.cand[k]),)
                                          if req.cand[k] >= 0 else ())
                    for k in em.line_req]
            assert keys == [k for k, _line in got_lines]

            parent = req.item[em.p_req]
            paths = [paths[p] + (int(c),) for p, c in zip(parent,
                                                          em.p_child)]
            items = (em.p_start, em.p_end, mlen[parent], seed_type[parent])
            assert [(paths[j], *(int(a[j]) for a in items),
                     cfg.motif_channel(int(items[2][j])))
                    for j in range(len(paths))] == next_pending
            pending = next_pending
            stats["rounds"] += 1
        return results
    finally:
        sess.close()


def _same_requests(req, want, pairs, paths, stats):
    assert req.n == len(want)
    for k, (q, (read, ref)) in enumerate(zip(want, pairs)):
        (key, kind, _s, a_start, a_len, _m, _t, atom, motif, unit, _e,
         _midx) = q
        cand = int(req.cand[k])
        assert (kind == "small") == (cand >= 0)
        assert key == paths[req.item[k]] + ((cand,) if cand >= 0 else ())
        assert (req.a_start[k], req.a_len[k], req.atom[k]) == (
            a_start, a_len, atom)
        assert req.unit[k] == (unit if kind == "small" else -1)
        got_ref = req.refs[req.ref_off[k]:req.ref_off[k + 1]]
        assert np.array_equal(req.reads[req.read_off[k]:req.read_off[k + 1]],
                              read.astype(np.int8))
        assert np.array_equal(got_ref, ref.astype(np.int8))
        assert "".join("ACGT"[c] for c in got_ref[:atom]) == motif
        stats["requests"] += 1
        stats["large"] += kind == "large"


def _count(sess, pending, req, stats):
    """Tally the items that fail the overlay gate, and the longer-motif
    items that pass it but fail mlen % atomicity (no request)."""
    asked = set(req.item.tolist())
    for j, (_key, s, e, m, _t, midx) in enumerate(pending):
        if sess.overlay_longest_run(midx, s, e) < 3:
            stats["gate_fail"] += 1
            assert j not in asked
        elif m > 10 and e - s >= 0.9 * m and j not in asked:
            stats["atom_fail"] += 1


@pytest.mark.parametrize("name", FIXTURES)
def test_round_entries_match_spec(golden_dir, name):
    cfg, contigs = _contigs(golden_dir, name)
    stats = dict.fromkeys(("rounds", "requests", "large", "gate_fail",
                           "atom_fail"), 0)
    for sid, seq in contigs:
        _walk(sid, seq, cfg, stats)
    assert stats["large"] and stats["atom_fail"], stats
    assert stats["requests"] > stats["large"], stats
    assert stats["rounds"] > (1 if name != "g3" else 0), stats


def _arbitrary_items(seq, cfg, n=400, seed=0):
    """Items no seed makes: spans of m to 4m at random positions (N runs
    among them), for motif lengths across the configuration."""
    rng = np.random.default_rng(seed)
    m = rng.integers(cfg.min_motif, cfg.max_motif + 1, n)
    span = (m * rng.uniform(0.8, 4.0, n)).astype(np.int64)
    start = rng.integers(0, max(len(seq) - int(span.max()) - 1, 1), n)
    return start, start + span, m, rng.integers(0, 3, n)


@pytest.mark.parametrize("name", ["g1", "M300"])
def test_round_requests_on_arbitrary_items(golden_dir, name):
    """The C requests (the C pool's form of the overlay gate) equal the
    spec's (the longest run against 3) on items that fail the overlay gate
    or the 0.9 guard (the seeds' items fail neither;
    test_round_entries_match_spec covers mlen % atomicity)."""
    cfg, contigs = _contigs(golden_dir, name)
    sid, seq = contigs[0]
    code, n_mask = encode(seq)
    sess = CoreSession(code, n_mask, cfg)
    try:
        sess.scan()
        translated = rb._translate_codes(seq)
        start, end, m, t = _arbitrary_items(seq, cfg)
        pending = [((j,), int(a), int(b), int(c), int(d),
                    cfg.motif_channel(int(c)))
                   for j, (a, b, c, d) in enumerate(zip(start, end, m, t))]
        want, pairs = rb._requests(pending, translated, code, n_mask, sess,
                                   cfg)
        stats = dict.fromkeys(("requests", "large", "gate_fail",
                               "atom_fail"), 0)
        req = sess.round_requests(translated, start, end, m,
                                  m - cfg.min_shift)
        _same_requests(req, want, pairs, [(j,) for j in range(400)], stats)
        _count(sess, pending, req, stats)
    finally:
        sess.close()
    assert stats["gate_fail"] and stats["requests"], stats


def _c_rounds(sid, seq, cfg, nthreads):
    """Every round's Requests and Emitted of one contig through the C
    entries, the C core's aligner giving the cigars."""
    lib = get_align_lib()
    code, n_mask = encode(seq)
    sess = CoreSession(code, n_mask, cfg)
    out = []
    try:
        _, items = rb.first_items(sess.scan())
        translated = rb._translate_codes(seq)
        while items[0].size:
            start, end, mlen, seed_type = items
            req = sess.round_requests(translated, start, end, mlen,
                                      mlen - cfg.min_shift,
                                      nthreads=nthreads)
            aligns = []
            for k in range(req.n):
                r = req.reads[req.read_off[k]:req.read_off[k + 1]]
                f = req.refs[req.ref_off[k]:req.ref_off[k + 1]]
                aligns.append(_ssw_align_native(r, f, lib)
                              if r.size and f.size else None)
            em = sess.round_emit(req, sid, start, end, mlen, seed_type,
                                 *_cigars(aligns), nthreads=nthreads)
            out.append((req, em))
            parent = req.item[em.p_req]
            items = (em.p_start, em.p_end, mlen[parent], seed_type[parent])
    finally:
        sess.close()
    return out


@pytest.mark.parametrize("name", ["m4-M37", "M300"])
def test_round_entries_do_not_depend_on_threads(golden_dir, name):
    cfg, contigs = _contigs(golden_dir, name)
    rounds = 0
    for sid, seq in contigs:
        one, eight = (_c_rounds(sid, seq, cfg, t) for t in (1, 8))
        assert len(one) == len(eight)
        rounds += len(one)
        for (r1, e1), (r8, e8) in zip(one, eight):
            for a, b in zip(r1 + e1, r8 + e8):
                if isinstance(a, np.ndarray):
                    assert np.array_equal(a, b)
                else:
                    assert a == b
    assert rounds > len(contigs)


def _run3(sess):
    fn = sess.lib.ribbit_core_overlay_run3
    fn.restype = ctypes.c_int32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                   ctypes.c_int64]
    return lambda midx, a, b: fn(sess.handle, midx, a, b)


@pytest.mark.parametrize("overlay", ["packed", "dropped", "injected"])
@pytest.mark.parametrize("name", FIXTURES)
def test_overlay_gate_forms_agree(golden_dir, name, overlay):
    """ribbit_core_overlay_run3 (the C pool's gate) and the longest run
    against 3 (_requests' gate) agree on every round-1 item and on
    arbitrary items: with the packed overlay that host generation builds,
    after it is dropped, and on a session of injected events (the gpu
    route's); on these items the C requests (the first form) equal
    _requests' (the second)."""
    from ribbit_tpu_torch.eventstitch import capture_runs_host

    cfg, contigs = _contigs(golden_dir, name)
    agreed = 0
    for sid, seq in contigs:
        code, n_mask = encode(seq)
        sess = CoreSession(code, n_mask, cfg)
        try:
            if overlay == "injected":
                sess.set_events(*capture_runs_host(code, n_mask, cfg))
            _, (start, end, m, _t) = rb.first_items(sess.scan())
            if overlay == "dropped":
                sess.drop_overlay()
            extra = _arbitrary_items(seq, cfg, n=200, seed=1)
            start, end, m = (np.concatenate([a, b]) for a, b in
                             zip((start, end, m), extra))
            run3 = _run3(sess)
            midx = m - cfg.min_shift
            for a, b, c in zip(start.tolist(), end.tolist(), midx.tolist()):
                assert bool(run3(c, a, b)) == (
                    sess.overlay_longest_run(c, a, b) >= 3)
                agreed += 1
            translated = rb._translate_codes(seq)
            pending = [((j,), a, b, c, 0, d) for j, (a, b, c, d) in
                       enumerate(zip(start.tolist(), end.tolist(),
                                     m.tolist(), midx.tolist()))]
            want, pairs = rb._requests(pending, translated, code, n_mask,
                                       sess, cfg)
            _same_requests(sess.round_requests(translated, start, end, m,
                                               midx), want, pairs,
                           [(j,) for j in range(len(pending))],
                           dict.fromkeys(("requests", "large"), 0))
        finally:
            sess.close()
    assert agreed


def test_route_equals_jax_package(cpu_jax, golden_dir):
    """g3 through the port's route (the C round entries, the plain SSW
    forward, the C traceback) against ribbit_tpu.refine_batched with its
    Pallas K3/K4 in interpret mode."""
    from ribbit_tpu.config import RibbitConfig as JaxConfig
    from ribbit_tpu.core import CoreSession as JaxSession
    from ribbit_tpu.encode import encode as jax_encode
    from ribbit_tpu.refine_batched import refine_batched as jax_refine

    jcfg, cfg = JaxConfig.create(), RibbitConfig.create()
    want, got = [], []
    for sid, seq in read_fasta(str(golden_dir / "g3.fa")):
        code, n_mask = jax_encode(seq)
        sess = JaxSession(code, n_mask, jcfg)
        try:
            want += jax_refine(sess.scan(), seq, sid, code, n_mask, sess,
                               jcfg, interpret=True)
        finally:
            sess.close()
        code, n_mask = encode(seq)
        sess = CoreSession(code, n_mask, cfg, nthreads=3)
        try:
            got += rb.refine_batched(sess.scan(), seq, sid, code, n_mask,
                                     sess, cfg, device="cpu")
        finally:
            sess.close()
    assert got == want and got


def test_route_is_taken_when_asked(tmp_path, monkeypatch):
    """On the gpu backend a FASTA of one record refines in the C pool, as
    do two records in the overlap loop; with RIBBIT_BATCHED_REFINE=1 each
    record refines through refine_batched (the JAX package's single-contig
    route, which the port takes only when asked).  Every BED equals the
    host route's."""
    from ribbit_tpu_torch import pipeline as pl

    calls = []
    route, pool = rb.refine_batched, CoreSession.refine
    monkeypatch.setattr(rb, "refine_batched",
                        lambda *a, **kw: calls.append("route")
                        or route(*a, **kw))
    monkeypatch.setattr(CoreSession, "refine",
                        lambda *a, **kw: calls.append("pool")
                        or pool(*a, **kw))
    cfg = RibbitConfig.create()
    contigs = [simulate(num_loci=3, seed=80 + i, n_block_rate=0.5).sequence
               for i in range(2)]
    for n in (1, 2):
        fa = tmp_path / f"{n}.fa"
        fa.write_text("".join(f">c{i}\n{s}\n"
                              for i, s in enumerate(contigs[:n])))
        monkeypatch.delenv("RIBBIT_BATCHED_REFINE", raising=False)
        host = pl.process_fasta(str(fa), cfg, scan_backend="host")
        for asked, want in (("", "pool"), ("1", "route")):
            monkeypatch.setenv("RIBBIT_BATCHED_REFINE", asked)
            calls.clear()
            assert pl.process_fasta(str(fa), cfg, device="cpu") == host
            assert calls == [want] * n and host


def test_take_gathers_cuts_and_reverses():
    """align_kernels.take (the route's gathers on the card) against numpy
    slicing: a subset in any order, cut prefixes reversed (the terminate
    pairs), new terminate targets; fits on arrays against its scalar
    form."""
    from ribbit_tpu_torch import align_kernels as ak

    rng = np.random.default_rng(5)
    reads = [rng.integers(0, 5, int(n)).astype(np.int8)
             for n in rng.integers(0, 300, 40)]
    refs = [rng.integers(0, 5, int(n)).astype(np.int8)
            for n in rng.integers(0, 900, 40)]
    p = ak.pack_pairs(reads, refs, device="cpu")
    idx = rng.permutation(40)[:25]
    rl = np.array([rng.integers(0, reads[i].size + 1) for i in idx])
    cl = np.array([rng.integers(0, refs[i].size + 1) for i in idx])
    term = rng.integers(-1, 50, 25)
    for reverse in (False, True):
        q = ak.take(p, idx, rl, cl, term, reverse=reverse)
        step = -1 if reverse else 1
        want = ak.pack_pairs(
            [reads[i][:n][::step] for i, n in zip(idx, rl)],
            [refs[i][:n][::step] for i, n in zip(idx, cl)], term.tolist(),
            device="cpu")
        for a, b in zip(q, want):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else np.array_equal(a, b))
    q = ak.take(p, idx)
    assert torch.equal(q.term, p.term[torch.from_numpy(idx)])
    with pytest.raises(ValueError):
        ak.take(p, idx[:1], rl[:1] + reads[idx[0]].size + 1, cl[:1])
    lens = np.array([[r, c] for r in range(0, 900, 13)
                     for c in range(0, 2700, 41)])
    assert ak.fits(lens[:, 0], lens[:, 1]).tolist() == [
        bool(ak.fits(int(r), int(c))) for r, c in lens]
