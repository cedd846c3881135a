"""The batched refinement route's C traceback (align.traceback_batch,
ribbit_tpu_torch/csrc/traceback.c: the shared C core's banded_sw and the
'='/'X' split over a round's located pairs, threaded) against its numpy
spec, the port's align.banded_sw + align._mark_mismatch and the JAX
package's (ribbit_tpu/align.py, numpy only).  Cigars and mismatch counts
are compared exactly.

The pairs: every live pair of refine_batched's first round on a small
simulated contig, located by the port's ssw_align spec, and edge pairs
(length 1, a read longer than its ref and the reverse, a score that
doubles the band, N on both sides, soft clips at both ends, a traceback
error).  Then the route itself: with the Python traceback made to raise,
refine_batched still gives g1's oracle BED, and a traceback library that
does not build makes it raise."""

import re

import numpy as np
import pytest

from chip_smoke import round1_pairs
from ribbit_tpu import align as jax_align

from ribbit_tpu_torch import align, native
from ribbit_tpu_torch import refine_batched as rb
from ribbit_tpu_torch.config import RibbitConfig
from ribbit_tpu_torch.core import CoreSession
from ribbit_tpu_torch.encode import encode
from ribbit_tpu_torch.fasta import read_fasta
from ribbit_tpu_torch.sim import simulate

ERROR_PAIR = (np.int8([2, 0, 2, 1, 1, 1, 0, 0, 1]), np.int8([2, 2, 2, 1, 2]))


def _edge_pairs():
    """(name, read, ref) pairs at the traceback's edges, located by
    ssw_align."""
    rng = np.random.default_rng(13)

    def bases(n):
        return rng.integers(0, 4, n).astype(np.int8)

    ref = bases(60)
    ins = np.concatenate([ref[:20], bases(6), ref[20:40], ref[46:]])
    unit = bases(7)
    n_ref = bases(50)
    n_ref[[10, 11, 30]] = 4
    n_read = n_ref.copy()
    n_read[20] = 4
    return [
        ("length 1", np.int8([2]), np.int8([2])),
        ("length-1 read, longer ref", np.int8([2]), np.int8([0, 2, 1])),
        ("longer read, length-1 ref", np.int8([1, 3, 2]), np.int8([2])),
        ("read longer than its ref",
         np.concatenate([ref[:20], bases(15), ref[20:40]]), ref[:40].copy()),
        ("ref longer than its read",
         np.concatenate([ref[:20], ref[35:]]), ref.copy()),
        ("6 I and 6 D at equal lengths: band 1 doubles", ins, ref.copy()),
        ("N on both sides", n_read, n_ref),
        ("soft clips at both ends",
         np.concatenate([bases(12), np.resize(unit, 60), bases(12)]),
         np.resize(unit, 80)),
    ]


def _spec(pairs, loc, banded_sw, mark_mismatch, alignment):
    out = []
    for (read, ref), (score, rb_, re_, qb, qe) in zip(pairs, zip(*loc)):
        al = alignment(sw_score=int(score), ref_begin=int(rb_),
                       ref_end=int(re_), query_begin=int(qb),
                       query_end=int(qe))
        sub_ref, sub_read = ref[rb_:re_ + 1], read[qb:qe + 1]
        ops = banded_sw(sub_ref, sub_read, int(score),
                        abs(sub_ref.shape[0] - sub_read.shape[0]) + 1)
        out.append(mark_mismatch(al, ref, read, read.shape[0], ops))
    return out


@pytest.fixture(scope="module")
def located():
    """Round-1 and edge pairs with their locations and both specs'
    (cigar, mismatches)."""
    seq = simulate(num_loci=6, seed=38, n_block_rate=0.1).sequence
    pairs = round1_pairs(seq, RibbitConfig.create())
    assert len(pairs) > 300
    names = ["round 1"] * len(pairs)
    for name, read, ref in _edge_pairs():
        names.append(name)
        pairs.append((read, ref))
    loc = []
    for read, ref in pairs:
        al = align.ssw_align(read, ref)
        assert al is not None and al.ref_end >= 0
        loc.append((al.sw_score, al.ref_begin, al.ref_end, al.query_begin,
                    al.query_end))
    # a score the located pair cannot reach: the tape walks out of the
    # band and the spec returns no ops
    names.append("traceback error")
    pairs.append(ERROR_PAIR)
    loc.append((1, 0, ERROR_PAIR[1].shape[0] - 1, 0,
                ERROR_PAIR[0].shape[0] - 1))
    loc = [np.array(c) for c in zip(*loc)]
    port = _spec(pairs, loc, align.banded_sw, align._mark_mismatch,
                 align.Alignment)
    jax = _spec(pairs, loc, jax_align.banded_sw, jax_align._mark_mismatch,
                jax_align.Alignment)
    assert port == jax
    return names, pairs, loc, port


@pytest.mark.parametrize("nthreads", [1, 3, 8])
def test_c_traceback_equals_both_specs(located, nthreads):
    names, pairs, loc, want = located
    cigars, mismatches = align.traceback_batch(pairs, *loc,
                                               nthreads=nthreads)
    assert mismatches.dtype == np.int32
    got = list(zip(cigars, mismatches.tolist()))
    bad = [(names[k], got[k], want[k]) for k in range(len(pairs))
           if got[k] != want[k]]
    assert not bad


def test_edge_pairs_take_their_paths(located):
    """Each edge pair reaches the case it is named for."""
    names, pairs, loc, want = located
    by_name = {n: (k, want[k]) for k, n in enumerate(names)}
    _, (cigar, mism) = by_name["length 1"]
    assert (cigar, mism) == ("1=", 0)
    # the location's lengths differ by under 6, so a 6 bp gap lies
    # outside the first band: banded_sw doubled it
    k, (cigar, _) = by_name["6 I and 6 D at equal lengths: band 1 doubles"]
    assert loc[2][k] - loc[1][k] == loc[4][k] - loc[3][k]
    assert "6I" in cigar and "6D" in cigar
    k, _ = by_name["read longer than its ref"]
    assert loc[4][k] - loc[3][k] > loc[2][k] - loc[1][k]
    k, _ = by_name["ref longer than its read"]
    assert loc[2][k] - loc[1][k] > loc[4][k] - loc[3][k]
    # N against N (at 10, 11 and 30) counts as '=', N against a base (at
    # 20) as 'X'
    k, (cigar, mism) = by_name["N on both sides"]
    assert (loc[3][k], loc[4][k]) == (0, 49)
    assert (cigar, mism) == ("20=1X29=", 1)
    _, (cigar, _) = by_name["soft clips at both ends"]
    assert re.fullmatch(r"\d+S.*\d+S", cigar)
    _, (cigar, mism) = by_name["traceback error"]
    assert (cigar, mism) == ("", 0)


def test_locations_are_checked():
    """A location outside its pair is refused before the C call; a score
    whose tape walks the ops off the pair (the spec raises IndexError)
    raises from the C call."""
    read, ref = ERROR_PAIR
    for bad in ((1, 0, 5, 0, 8), (1, 0, 4, 0, 9), (1, 2, 1, 0, 8),
                (1, -1, 4, 0, 8)):
        with pytest.raises(ValueError):
            align.traceback_batch([(read, ref)], *([v] for v in bad))
    read = np.int8([2, 3, 0, 4, 0])
    ref = np.int8([4, 1, 3, 2, 3, 1, 1, 3, 0, 1, 3])
    with pytest.raises(IndexError):
        _spec([(read, ref)], [[2], [5], [10], [4], [4]], align.banded_sw,
              align._mark_mismatch, align.Alignment)
    with pytest.raises(RuntimeError, match="walked off"):
        align.traceback_batch([(read, ref)], [2], [5], [10], [4], [4])
    assert align.traceback_batch([], [], [], [], [], [])[0] == []


def test_left_band_walk_differs_from_the_spec():
    """Pinned difference: a target the pair cannot reach can walk a D run
    past the band's first column.  The shared C core's tape read
    (band_traceback, csrc/ribbit_align.c:557) then takes the previous
    row's last cell, where the numpy spec's index -1 wraps to the same
    row's last cell: the spec reports a traceback error, the C core a
    cigar.  No located pair of the route has shown it (the test above and
    chip_smoke.py phase 6 hold every one they build equal)."""
    read = np.int8([0, 0, 0, 4, 2, 3, 0, 3, 0, 4, 4, 1])
    ref = np.int8([4, 4, 2, 4, 4, 4, 0, 2, 4])
    loc = [[2], [0], [8], [1], [9]]
    want = _spec([(read, ref)], loc, jax_align.banded_sw,
                 jax_align._mark_mismatch, jax_align.Alignment)
    assert want == [("", 0)]
    cigars, mismatches = align.traceback_batch([(read, ref)], *loc)
    assert (cigars[0], int(mismatches[0])) == ("1S1X3D1X4D2S", 9)


def _g1(golden_dir, device="cpu"):
    cfg = RibbitConfig.create()
    lines = []
    for sid, seq in read_fasta(str(golden_dir / "g1.fa")):
        code, n_mask = encode(seq)
        sess = CoreSession(code, n_mask, cfg)
        try:
            lines += rb.refine_batched(sess.scan(), seq, sid, code, n_mask,
                                       sess, cfg, device=device)
        finally:
            sess.close()
    return lines


def test_route_never_reaches_the_python_traceback(golden_dir, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the Python traceback ran")

    monkeypatch.setattr(align, "banded_sw", refuse)
    monkeypatch.setattr(align, "_mark_mismatch", refuse)
    want = (golden_dir / "g1.oracle.bed").read_text().splitlines()
    assert _g1(golden_dir) == want


def test_failed_build_raises(golden_dir, tmp_path, monkeypatch):
    """No compiler on PATH and an empty build directory: refine_batched
    raises with the build's error and falls back to nothing."""
    seq = next(read_fasta(str(golden_dir / "g1.fa")))[1]
    cfg = RibbitConfig.create()
    code, n_mask = encode(seq)
    sess = CoreSession(code, n_mask, cfg)     # the C core, built before
    try:
        seeds = sess.scan()
        monkeypatch.setattr(native, "_BUILD", tmp_path / "native")
        monkeypatch.setenv("PATH", str(tmp_path))
        native.get_traceback_lib.cache_clear()
        with pytest.raises(RuntimeError, match="traceback.c did not build"):
            rb.refine_batched(seeds, seq, "g1", code, n_mask, sess, cfg,
                              device="cpu")
    finally:
        native.get_traceback_lib.cache_clear()
        sess.close()
