"""The port's SSW forward scoring (ribbit_tpu_torch.align_kernels) against
the JAX package: the plain PyTorch version of both CUDA kernels equals the
three Pallas kernels run in interpret mode (align_pallas_v3, K3;
align_pallas, K4; align_pallas_v2, K9, which ssw_forward_small serves)
and the JAX package's numpy spec (align._forward_pass, the forward pass
of ssw_align) on all four outputs, in forward and terminate mode; with
the port's C batch traceback they give ssw_align's alignments.  Integer DP scores: the
tolerance is exact equality.

The CUDA kernels themselves run only on a card; chip_smoke.py holds them
against this plain version there, at the route's shapes.  Their host-side
launch plan (align_kernels.launch_plan) is tested here."""

import dataclasses

import numpy as np
import pytest
import torch

from ribbit_tpu import align as jax_align
from ribbit_tpu import align_pallas_v3

from ribbit_tpu_torch import align, align_kernels as ak, refine_batched

torch.set_num_threads(2)

BASES = "ACGTN"


def _pairs(seed, n, max_read, max_ref):
    """Seeded (read, ref) code pairs: half repeats with noise, half random
    bases with N, as tests/test_pallas.py makes them."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    for t in range(n):
        n1 = int(rng.integers(1, max_read + 1))
        n2 = int(rng.integers(1, max_ref + 1))
        if t % 2 == 0:
            motif = "".join(BASES[i] for i in rng.integers(
                0, 4, int(rng.integers(2, 12))))
            q = list((motif * (n1 // len(motif) + 1))[:n1])
            for k in rng.integers(0, len(q), max(1, n1 // 8)):
                q[int(k)] = BASES[int(rng.integers(0, 5))]
            reads.append(align.translate("".join(q)))
            refs.append(align.translate(
                (motif * (n2 // len(motif) + 1))[:n2]))
        else:
            reads.append(align.translate("".join(
                BASES[i] for i in rng.integers(0, 5, n1))))
            refs.append(align.translate("".join(
                BASES[i] for i in rng.integers(0, 5, n2))))
    return reads, refs


def _spec(reads, refs, terms=None, forward_pass=jax_align._forward_pass):
    """(score, end_ref, end_read, first_hit) by a numpy spec: the JAX
    package's, or the port's copy (align._forward_pass)."""
    out = []
    for i, (rd, rf) in enumerate(zip(reads, refs)):
        t = -1 if terms is None or terms[i] is None else terms[i]
        if rd.shape[0] == 0:
            # the spec needs a row; the Pallas kernels' contract: every
            # column's max is 0
            out.append((0, -1, -1, 0 if t == 0 and rf.shape[0] else -1))
            continue
        best, er, bc, mc = forward_pass(rd, rf, terminate=t)
        erd = int(np.flatnonzero(bc == best)[0]) if er >= 0 else -1
        hit = np.flatnonzero(mc == t) if t >= 0 else []
        out.append((best, er, erd, int(hit[0]) if len(hit) else -1))
    return tuple(np.array(c) for c in zip(*out))


def _reverse(reads, refs, fwd):
    """Reverse-pass inputs as refine_batched._reverse_pairs builds them."""
    score, end_ref, end_read, _ = fwd
    keep = [i for i in range(len(reads)) if end_ref[i] >= 0]
    rr = [reads[i][:int(end_read[i]) + 1][::-1].copy() for i in keep]
    fr = [refs[i][:int(end_ref[i]) + 1][::-1].copy() for i in keep]
    return rr, fr, [int(score[i]) for i in keep]


def _plain(reads, refs, terms=None):
    return ak.forward(ak.ssw_forward_ref, reads, refs, terms, device="cpu")


def _assert_same(got, want, what):
    for name, g, w in zip(("score", "end_ref", "end_read", "first_hit"),
                          got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64),
                                      err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def small_pairs():
    reads, refs = _pairs(6, 24, 40, 48)
    assert all(ak.fits(a.shape[0], b.shape[0]) for a, b in zip(reads, refs))
    return reads, refs


@pytest.fixture(scope="module")
def oversized_pairs():
    reads, refs = _pairs(8, 3, 700, 900)
    reads[0] = reads[0][:1]
    reads.append(align.translate("ACGT" * 180))        # 3R + C past 2560
    refs.append(align.translate("ACGT" * 200))
    assert not all(ak.fits(a.shape[0], b.shape[0])
                   for a, b in zip(reads, refs))
    return reads, refs


def _strip_edges():
    """(reads, refs, terms) at the striped wavefront's edges, kept small for
    interpret mode: rows around multiples of 8 and 32 (strips of one lane,
    R < 32, R not a multiple of the lanes) against short (C < 32) and
    longer refs, one column max attained in two strips (the smaller row
    wins), and terminate targets hit at column 0, at the last column and
    never."""
    rng = np.random.default_rng(11)
    reads, refs = [], []
    for R in (8, 31, 32, 33, 63, 64, 65):
        for C in (5, 20, 90):
            unit = rng.integers(0, 4, int(rng.integers(2, 9))).astype(np.int8)
            r = np.resize(unit, R).copy()
            hit = rng.random(R) < 0.08
            r[hit] = rng.integers(0, 5, int(hit.sum()))
            reads.append(r)
            refs.append(np.resize(unit, C).astype(np.int8))
    x = rng.integers(0, 4, 40).astype(np.int8)
    reads.append(np.concatenate([x, x]))
    refs.append(x.copy())
    terms = [None] * len(reads)
    reads += [np.int8([2, 1, 0]), x.copy(), x.copy()]
    refs += [np.int8([2, 3, 3, 3]), x.copy(), x.copy()]
    terms += [2, 2 * len(x), 999]
    return reads, refs, terms


@pytest.mark.parametrize("batch,mode", [
    pytest.param("random", "forward", id="forward"),
    pytest.param("random", "terminate", id="terminate"),
    pytest.param("strip edges", "forward", id="strip-edges-forward"),
    pytest.param("strip edges", "terminate", id="strip-edges-terminate")])
def test_plain_matches_pallas_k3_k4_and_spec(cpu_jax, small_pairs, batch,
                                             mode):
    """Pairs of K3's class: the plain version equals K3 and K4 in
    interpret mode and the numpy spec; on the strip edges the terminate
    mode also takes the edges' own targets."""
    from ribbit_tpu import align_pallas
    reads, refs = small_pairs
    terms = None
    if batch == "strip edges":
        reads, refs, targets = _strip_edges()
        assert all(ak.fits(a.shape[0], b.shape[0])
                   for a, b in zip(reads, refs))
    if mode == "terminate":
        rr, fr, terms = _reverse(reads, refs, _spec(reads, refs))
        if batch == "strip edges":
            keep = [i for i, t in enumerate(targets) if t is not None]
            rr += [reads[i] for i in keep]
            fr += [refs[i] for i in keep]
            terms += [targets[i] for i in keep]
        reads, refs = rr, fr
    got = _plain(reads, refs, terms)
    _assert_same(got, _spec(reads, refs, terms), "spec")
    _assert_same(got, _spec(reads, refs, terms, align._forward_pass),
                 "the port's spec")
    _assert_same(got, align_pallas_v3.batch_forward(
        reads, refs, terms, interpret=True), "K3")
    _assert_same(got, align_pallas.batch_forward(
        reads, refs, terms, interpret=True), "K4")


def _pallas_pairs(seed):
    """tests/test_pallas.py:269's 24 (read, ref) pairs."""
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    for t in range(24):
        n1 = int(rng.integers(3, 160))
        n2 = int(rng.integers(3, 180))
        if t % 2 == 0:
            motif = "".join(BASES[i] for i in rng.integers(
                0, 4, int(rng.integers(2, 12))))
            q = list((motif * 40)[:n1])
            for k in rng.integers(0, max(1, len(q)), max(1, n1 // 8)):
                q[int(k)] = BASES[int(rng.integers(0, 5))]
            reads.append(align.translate("".join(q)))
            refs.append(align.translate((motif * 60)[:n2]))
        else:
            reads.append(align.translate("".join(
                BASES[i] for i in rng.integers(0, 5, n1))))
            refs.append(align.translate("".join(
                BASES[i] for i in rng.integers(0, 5, n2))))
    return reads, refs


@pytest.mark.parametrize("mode", ["forward", "terminate"])
def test_plain_matches_pallas_k9(cpu_jax, mode):
    """K9 (align_pallas_v2, K3 without row blocks) in interpret mode on
    tests/test_pallas.py:269's pairs, all within fits(): ssw_forward_small
    serves it, so the plain version must equal its four outputs."""
    from ribbit_tpu import align_pallas_v2
    reads, refs = _pallas_pairs(7)
    assert all(ak.fits(a.shape[0], b.shape[0]) for a, b in zip(reads, refs))
    terms = None
    if mode == "terminate":
        reads, refs, terms = _reverse(reads, refs, _spec(reads, refs))
    got = _plain(reads, refs, terms)
    _assert_same(got, align_pallas_v2.batch_forward(
        reads, refs, terms, interpret=True), "K9")
    _assert_same(got, _spec(reads, refs, terms), "spec")


@pytest.mark.parametrize("mode", ["forward", "terminate"])
def test_plain_matches_spec_on_oversized_pairs(oversized_pairs, mode):
    """Pairs past fits() (K4's class in refine_batched): the plain version
    equals the numpy spec."""
    reads, refs = oversized_pairs
    terms = None
    if mode == "terminate":
        reads, refs, terms = _reverse(reads, refs, _spec(reads, refs))
    _assert_same(_plain(reads, refs, terms), _spec(reads, refs, terms),
                 "spec")


def test_plain_edge_pairs():
    """Length-1, all-N, empty and terminate-never-reached pairs."""
    t = align.translate
    reads = [t("A"), t("A"), t("NNNN"), t("ACGT"), t(""), t("ACGTACGT")]
    refs = [t("A"), t("C"), t("NNNNNN"), t(""), t("ACGT"), t("ACGTACGT")]
    _assert_same(_plain(reads, refs), _spec(reads, refs), "forward")
    terms = [2, None, 0, 3, 1, 99]
    got = _plain(reads, refs, terms)
    _assert_same(got, _spec(reads, refs, terms), "terminate")
    assert got[3][5] == -1                       # 99 is never reached


def _strip_bounds(R: int, lanes: int, strip: int):
    """[(band, lane, first row, end row)] of every lane that owns rows of a
    pair of R rows, as csrc/ssw_forward.cu maps them: band b, lane k owns
    rows b*lanes*strip + k*strip up to strip rows, cut at R."""
    out = []
    band_rows = lanes * strip
    for b in range(max(1, -(-R // band_rows))):
        for k in range(lanes):
            lo = b * band_rows + k * strip
            if lo >= R:
                break
            out.append((b, k, lo, min(lo + strip, R)))
    return out


# lengths at the plan's edges: empty, 1, strips of one lane, the register
# buckets' edges on 32 and 256 lanes, and bands of the largest bucket
PLAN_ROWS = [0, 1, 8, 31, 32, 33, 64, 65, 192, 193, 512, 513, 602, 853,
             1024, 1025, 4096, 4610, 8192, 8193, 17000, 29999]


# strip tables (rows a lane, descending): the kernels' six
# (csrc/ssw_forward.cu's SSW_STRIPS), and ten, five and one
STRIP_TABLES = [(32, 20, 12, 8, 4, 1), (32, 24, 20, 16, 12, 8, 6, 4, 2, 1),
                (32, 16, 8, 4, 1), (32,)]


@pytest.mark.parametrize("strips", STRIP_TABLES,
                         ids=lambda t: f"{len(t)}-strips")
@pytest.mark.parametrize("lanes", [ak.SMALL_LANES, ak.LARGE_LANES])
def test_launch_plan(lanes, strips):
    """Every pair once, bucket after bucket in the table's order with the
    counts given, cells descending within a bucket; each pair's strip is
    the smallest bucket that holds its rows in one band, or the largest in
    as many bands as it takes; the kernel's strips cover [0, R) once, none
    longer than its bucket."""
    rng = np.random.default_rng(lanes)
    rlen = np.array(PLAN_ROWS + list(rng.integers(0, 3000, 200)), np.int64)
    clen = rng.integers(0, 6000, len(rlen)).astype(np.int64)
    plan = ak.launch_plan(rlen, clen, lanes, strips)
    order = np.argsort(plan.key, kind="stable")
    assert sorted(order.tolist()) == list(range(len(rlen)))
    assert plan.counts.sum() == len(rlen)
    assert len(plan.counts) == len(strips)
    start = 0
    for s, cnt in zip(strips, plan.counts):
        group = order[start:start + cnt]
        assert (plan.strip[group] == s).all()
        cells = rlen[group] * clen[group]
        assert (np.diff(cells) <= 0).all()
        start += cnt
    for R, s, b in zip(rlen, plan.strip, plan.bands):
        rows = max(int(R), 1)
        smaller = [t for t in strips if t < s]
        if b == 1:
            assert rows <= lanes * s
            assert not smaller or rows > lanes * max(smaller)
        else:
            assert s == strips[0]
            assert lanes * s * (b - 1) < rows <= lanes * s * b
        bounds = _strip_bounds(int(R), lanes, int(s))
        covered = [j for _, _, lo, hi in bounds for j in range(lo, hi)]
        assert covered == list(range(int(R)))
        assert all(0 < hi - lo <= s and k < lanes for _, k, lo, hi in bounds)
        assert max((bb for bb, _, _, _ in bounds), default=0) < b


def test_fits_matches_pallas_v3():
    for r in range(0, 900, 7):
        for c in range(0, 2700, 37):
            assert ak.fits(r, c) == align_pallas_v3.fits(r, c), (r, c)


def test_align_copy_matches_jax_package(small_pairs, oversized_pairs):
    """refine_batched._device_align (the plain forward passes, then the C
    batch traceback, align.traceback_batch) gives the JAX package's
    ssw_align alignments."""
    fields = dataclasses.astuple
    for reads, refs in (small_pairs, oversized_pairs):
        pairs = list(zip(reads, refs))
        got = refine_batched._device_align(pairs, "cpu")
        for (rd, rf), al in zip(pairs, got):
            assert fields(al) == fields(jax_align.ssw_align(rd, rf))


def test_wrappers_check_inputs_and_count_no_cpu_launches(small_pairs):
    reads, refs = small_pairs
    p = ak.pack_pairs(reads, refs, device="cpu")
    n0 = (ak.ssw_forward_small.launches, ak.ssw_forward_large.launches)
    want = ak.ssw_forward_ref(p)
    assert torch.equal(ak.ssw_forward_small(p), want)
    assert torch.equal(ak.ssw_forward_large(p), want)
    assert (ak.ssw_forward_small.launches,
            ak.ssw_forward_large.launches) == n0
    for bad in (p._replace(read=p.read.to(torch.int32)),
                p._replace(term=p.term[:-1]),
                p._replace(read_off=p.read_off.to(torch.int32)),
                p._replace(ref=p.ref[:-1])):
        for fn in (ak.ssw_forward_small, ak.ssw_forward_large):
            with pytest.raises(ValueError):
                fn(bad)
    with pytest.raises(ValueError):
        ak.pack_pairs(reads, refs[:-1], device="cpu")


def test_cuda_without_cuda_raises(small_pairs):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    reads, refs = small_pairs
    with pytest.raises(RuntimeError, match="is_available"):
        ak.pack_pairs(reads, refs, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        ak.forward(ak.ssw_forward_small, reads, refs)
