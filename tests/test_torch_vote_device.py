"""The port's device-batched diagonal voter (ribbit_tpu_torch.vote_device)
on the CPU against the JAX package's (ribbit_tpu.vote_device, XLA on the
CPU), the C voter (ribbit_vote_longer) and the scalar spec
(_most_frequent_longer_motif_scalar): packing, the count table, both
bucket kernels' (totals, upstream cursors, overflow flags), the prefix
votes and the winners.  All results are integers: the tolerance is exact
equality.

Motifs past 127 bp: the port's tables are int16 and its one-hot product
float16, so it equals the C voter up to -M 300.  The JAX package's banded
tables are int8 and wrap there; that difference is pinned as expected
(test_large_motifs_pin_jax_int8_wrap), and a fix of the JAX package shows
as a failing expectation.

The JAX voter pads every batch to batch_size_of(ssl_pad) runs (up to 64)
for its static shapes; the tests cap that at a few runs (results do not
depend on the batch, whose runs are independent) so that each bucket's
compile and run stay small."""

import numpy as np
import pytest
import torch

from ribbit_tpu import vote_device as jvd
from ribbit_tpu.refine import (
    _most_frequent_longer_motif_scalar as jax_scalar)

from ribbit_tpu_torch import vote_device as vd
from ribbit_tpu_torch.refine import (_most_frequent_longer_motif_scalar,
                                     most_frequent_longer_motif)

torch.set_num_threads(2)

IMPLS = ("banded", "spec")
JAX_BATCH = 3
# the m >= 128 runs: drawn in this order from default_rng(5) with
# ssl = 3m + 17, seed_start 10 and L = ssl + m + 40
LARGE_M = (150, 160, 170, 180, 190, 200)
# where the JAX banded walk's int8 tables have wrapped: its winners, and
# the C voter's (the spec's)
JAX_INT8_WRAP = {180: (365, 280), 190: (158, 107), 200: (409, 345)}


def _repeatish(rng, L, m):
    """Tandem-repeat-heavy sequence: the workload the voter sees
    (tests/test_vote_device.py's generator)."""
    unit = rng.integers(0, 4, m, dtype=np.int8)
    code = np.tile(unit, L // m + 1)[:L].copy()
    nmut = max(1, L // 12)
    pos = rng.choice(L, size=nmut, replace=False)
    kind = rng.integers(0, 3, nmut)
    code[pos[kind == 0]] = rng.integers(0, 4, int((kind == 0).sum()))
    for p in pos[kind == 1][:4]:          # small indel-ish shifts
        code[p:] = np.roll(code[p:], 1)
    n_mask = np.zeros(L, dtype=bool)
    n_mask[pos[kind == 2]] = True
    return code, n_mask


def _c_index(code, n_mask, run):
    return vd._host_index(code, n_mask, *run)


@pytest.fixture
def jax_voter(cpu_jax, monkeypatch):
    """The JAX package's vote_device with its batches capped at JAX_BATCH
    runs."""
    monkeypatch.setattr(jvd, "batch_size_of",
                        lambda ssl_pad, bytes_cap=0: JAX_BATCH)
    return jvd


def _contig(seed=1, L=3000, m=17):
    return _repeatish(np.random.default_rng(seed), L, m)


def _bucket_runs(L, ssl_pad, m_pad, n, seed):
    """n runs of one (ssl_pad, m_pad) bucket on a contig of L bp."""
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(n):
        m = int(rng.integers(max(11, m_pad // 2 + 1), min(m_pad, 100) + 1))
        ssl = int(rng.integers(max(ssl_pad // 2 + 1, m + 2), ssl_pad + 1))
        runs.append((int(rng.integers(0, L - ssl - m - 3)), ssl, m))
    assert {vd.bucket_of(s, m) for _, s, m in runs} == {(ssl_pad, m_pad)}
    return runs


# a handful of buckets of the real call set's shapes (m 11-100)
BUCKETS = ((128, 16), (128, 32), (256, 64), (512, 128))


def _packed(ssl_pad, m_pad, n=JAX_BATCH, seed=0):
    code, n_mask = _contig()
    runs = _bucket_runs(code.shape[0], ssl_pad, m_pad, n, seed)
    return code, n_mask, runs, vd._pack_bucket(code, n_mask, runs, ssl_pad,
                                               m_pad)


def test_bucket_of_and_batch_size():
    assert vd.bucket_of(11, 11) == (128, 16)
    assert vd.bucket_of(129, 17) == (256, 32)
    assert vd.bucket_of(617, 200) == (1024, 256)
    assert vd.bucket_of(700, 300) == (1024, 512)
    # three int16 tables of [ssl_pad, 2 ssl_pad + 16] in 384 MiB, at most 64
    assert [vd.batch_size_of(p) for p in (128, 512, 1024, 2048, 4096,
                                          8192)] == [64, 64, 31, 7, 1, 1]


def test_pack_bucket_matches_jax(cpu_jax):
    code, n_mask = _contig()
    L = code.shape[0]
    runs = [(0, 60, 12), (L - 80 - 13, 80, 13), (1, 100, 30), (500, 90, 20)]
    got = vd._pack_bucket(code, n_mask, runs, 128, 32)
    want = jvd._pack_bucket(code, n_mask, runs, 128, 32)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.mark.parametrize("bucket", BUCKETS[1:3])
def test_count_table_matches_jax(cpu_jax, bucket):
    ssl_pad, m_pad = bucket
    _, _, _, arrs = _packed(ssl_pad, m_pad)
    kw = dict(m_pad=m_pad, R_pad=ssl_pad, B_pad=ssl_pad + 8)
    got = vd._count_table(*(torch.from_numpy(a) for a in arrs[:4]), **kw)
    want = np.asarray(jvd._count_table(
        *(cpu_jax.numpy.asarray(a.astype(np.int32) if a.dtype == np.int8
                                else a) for a in arrs[:4]), **kw))
    assert got.dtype == torch.int16
    assert got.max() > 0
    assert np.array_equal(got.numpy().astype(np.int32), want)


def _bucket_outputs(mod, impl, arrs, ssl_pad, m_pad, w_band):
    kw = dict(m_pad=m_pad, R_pad=ssl_pad, B_pad=ssl_pad + 8)
    if impl == "banded":
        kw["w_band"] = w_band
    kern = mod._vote_bucket if impl == "banded" else mod._vote_bucket_spec
    if mod is vd:
        out = kern(*(torch.from_numpy(a) for a in arrs), **kw)
        return [t.numpy().astype(np.int64) for t in out[:3]], out[3]
    import jax.numpy as jnp
    out = kern(*(jnp.asarray(a.astype(np.int32) if a.dtype == np.int8
                             else a) for a in arrs), **kw)
    return [np.asarray(t).astype(np.int64) for t in out], None


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bucket", BUCKETS[1:3])
def test_vote_bucket_matches_jax(cpu_jax, impl, bucket):
    """(row totals, final upstream cursors, overflow flags) of every row,
    the padding rows among them."""
    ssl_pad, m_pad = bucket
    _, _, _, arrs = _packed(ssl_pad, m_pad)
    got, steps = _bucket_outputs(vd, impl, arrs, ssl_pad, m_pad, 128)
    want, _ = _bucket_outputs(jvd, impl, arrs, ssl_pad, m_pad, 128)
    for name, g, w in zip(("totals", "w_up", "overflow"), got, want):
        assert np.array_equal(g, w), name
    assert got[0].max() > 0 and steps > 0


def test_vote_bucket_overflowed_band_matches_jax(cpu_jax):
    """w_band = 8 overflows on random content; the flags and the totals
    read at the clipped band offsets equal the JAX package's too."""
    rng = np.random.default_rng(11)
    code = rng.integers(0, 4, 900, dtype=np.int8)
    n_mask = np.zeros(900, dtype=bool)
    runs = [(10, 700, 13), (100, 600, 29), (5, 520, 17)]
    arrs = vd._pack_bucket(code, n_mask, runs, 1024, 32)
    got, _ = _bucket_outputs(vd, "banded", arrs, 1024, 32, 8)
    want, _ = _bucket_outputs(jvd, "banded", arrs, 1024, 32, 8)
    assert got[2].all()
    for name, g, w in zip(("totals", "w_up", "overflow"), got, want):
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("impl", IMPLS)
def test_vote_longer_batch_matches_jax_and_c(jax_voter, impl):
    """Two dozen runs over four buckets on one contig: the port, the JAX
    package and the C voter give the same winners."""
    code, n_mask = _contig(seed=2, L=2500, m=23)
    runs = [r for k, b in enumerate(BUCKETS)
            for r in _bucket_runs(code.shape[0], *b, 6, seed=10 + k)]
    got = vd.vote_longer_batch(code, n_mask, runs, impl=impl, device="cpu")
    want = [_c_index(code, n_mask, r) for r in runs]
    assert got == want
    assert jax_voter.vote_longer_batch(code, n_mask, runs, impl=impl) == want


@pytest.mark.parametrize("impl", IMPLS)
def test_vote_mixed_buckets_and_edges(impl):
    """tests/test_vote_device.py's mixed-bucket contig: random runs over
    several buckets, the upstream gate at the contig's start, the right
    edge, one candidate row and none."""
    rng = np.random.default_rng(7)
    L = 4096
    code, n_mask = _repeatish(rng, L, 17)
    runs = []
    for _ in range(30):
        m = int(rng.integers(11, 80))
        ssl = int(rng.integers(m + 2, 500))
        ss = int(rng.integers(0, max(1, L - ssl - m - 3)))
        runs.append((ss, ssl, m))
    runs += [(0, 60, 12),                  # c0 < 0 upstream gate
             (L - 80 - 13, 80, 13),        # right boundary
             (5, 12, 12),                  # single candidate row
             (5, 11, 12)]                  # no candidate rows -> 0
    assert len({vd.bucket_of(s, m) for _, s, m in runs}) >= 6
    got = vd.vote_longer_batch(code, n_mask, runs, impl=impl, device="cpu")
    want = [_c_index(code, n_mask, r) if r[1] - r[2] + 1 > 0 else 0
            for r in runs]
    assert got == want
    assert got[-1] == 0


@pytest.mark.parametrize("impl", IMPLS)
def test_ragged_batches(impl):
    """A bucket of more runs than one batch holds (64 + 6): the last batch
    is ragged, and every winner equals the C voter's."""
    code, n_mask = _contig(seed=3, L=2000, m=13)
    runs = _bucket_runs(code.shape[0], 128, 16, 70, seed=4)
    assert vd.batch_size_of(128) == 64
    got = vd.vote_longer_batch(code, n_mask, runs, impl=impl, device="cpu")
    assert got == [_c_index(code, n_mask, r) for r in runs]


@pytest.mark.parametrize("impl", IMPLS)
def test_all_n_windows_give_index_zero(impl):
    """All-N windows score zero everywhere; the spec leaves the index at 0
    (parse_seed.cpp:238-244)."""
    code = np.zeros(256, dtype=np.int8)
    n_mask = np.ones(256, dtype=bool)
    runs = [(64, 100, 12), (3, 200, 40)]
    assert vd.vote_longer_batch(code, n_mask, runs, impl=impl,
                                device="cpu") == [0, 0]
    assert [_c_index(code, n_mask, r) for r in runs] == [0, 0]


def test_band_overflow_revotes_on_host():
    """A band of 8 overflows on random content: the run re-votes on the C
    voter (counted) and the winner is exact."""
    rng = np.random.default_rng(11)
    code = rng.integers(0, 4, 900, dtype=np.int8)
    n_mask = np.zeros(900, dtype=bool)
    run = (10, 700, 13)
    before = vd.vote_longer_batch.overflows
    got = vd.vote_longer_batch(code, n_mask, [run], w_band=8, device="cpu")
    assert vd.vote_longer_batch.overflows == before + 1
    assert got == [_c_index(code, n_mask, run)]
    # the default band holds it on the device
    before = vd.vote_longer_batch.overflows
    assert vd.vote_longer_batch(code, n_mask, [run], device="cpu") == got
    assert vd.vote_longer_batch.overflows == before


@pytest.mark.parametrize("seed", [3, 4])
def test_prefix_counts(cpu_jax, seed):
    """The C core's prefix votes equal the numpy reference and the JAX
    package's."""
    rng = np.random.default_rng(seed)
    code, n_mask = _repeatish(rng, 600, 13)
    ss, ssl, m = 40, 300, 13
    R = ssl - m + 1
    # plausible final upstream cursors: at or below seed_start
    ustream = ss - rng.integers(0, m + 3, R).astype(np.int64)
    got = vd._prefix_counts(code, n_mask, ss, ssl, m, ustream)
    assert got.max() > 0
    assert np.array_equal(got, vd._prefix_counts_np(code, n_mask, ss, ssl,
                                                    m, ustream))
    assert np.array_equal(got, jvd._prefix_counts(code, n_mask, ss, ssl, m,
                                                  ustream))


@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_spec_matches_jax_and_c(seed):
    """The scalar spec equals the JAX package's and the C voter's unit on
    small runs."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        m = int(rng.integers(11, 25))
        ssl = int(rng.integers(m + 2, 5 * m))
        pad = int(rng.integers(0, 20))
        L = ssl + 2 * pad + m + 4
        code, n_mask = _repeatish(rng, L, m)
        got = _most_frequent_longer_motif_scalar(code, n_mask, pad, ssl, m, L)
        assert got == jax_scalar(code, n_mask, pad, ssl, m, L)
        assert got == most_frequent_longer_motif(code, n_mask, pad, ssl, m, L)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, n_mask = _contig()
    with pytest.raises(RuntimeError, match="is_available"):
        vd.vote_longer_batch(code, n_mask, [(10, 100, 20)])
    with pytest.raises(RuntimeError, match="is_available"):
        vd.vote_longer_batch(code, n_mask, [(10, 100, 20)], impl="spec",
                             device="cuda:0")


def _large_runs():
    rng = np.random.default_rng(5)
    cases = {}
    for m in LARGE_M:
        ssl = 3 * m + 17
        cases[m] = (_repeatish(rng, ssl + m + 40, m), (10, ssl, m))
    return cases


@pytest.mark.parametrize("impl", IMPLS)
def test_large_motifs_match_c_voter(impl):
    """m = 150-200 (past int8): both of the port's walks equal the C
    voter."""
    for m, ((code, n_mask), run) in _large_runs().items():
        want = _c_index(code, n_mask, run)
        if m in JAX_INT8_WRAP:
            assert want == JAX_INT8_WRAP[m][1]
        assert vd.vote_longer_batch(code, n_mask, [run], impl=impl,
                                    device="cpu") == [want], m


def test_large_motifs_pin_jax_int8_wrap(jax_voter):
    """At m = 180, 190 and 200 the JAX spec walk (int32 tables) equals the
    C voter and the JAX banded walk (int8 tables, which wrap past 127)
    does not: pinned, winner for winner."""
    cases = _large_runs()
    for m, (jax_banded, c_voter) in JAX_INT8_WRAP.items():
        (code, n_mask), run = cases[m]
        assert _c_index(code, n_mask, run) == c_voter
        assert jax_voter.vote_longer_batch(code, n_mask, [run],
                                           impl="spec") == [c_voter], m
        assert jax_voter.vote_longer_batch(code, n_mask, [run],
                                           impl="banded") == [jax_banded], m


def _count_table_np(codew, nmaskw, m, ssl, R_pad, B_pad):
    """C[r, b] = sum_{i<m} [code(2+r+i) == code(b+i) < 4] and the b side
    unmasked and before seed_end, for one packed run."""
    C = np.zeros((R_pad, B_pad), dtype=np.int64)
    b = np.arange(B_pad)
    for i in range(m):
        a = codew[2 + i:2 + i + R_pad]
        bc = codew[i:i + B_pad]
        ok = (bc < 4) & ~nmaskw[i:i + B_pad] & (b + i < ssl + 2)
        C += (a[:, None] == bc[None, :]) & ok[None, :]
    return C


def test_count_table_exact_past_256():
    """A perfect repeat of a 300 bp unit (-M 300): counts of 300 on its
    diagonal, past bfloat16's exact integers, stay exact, and both walks
    equal the C voter."""
    rng = np.random.default_rng(9)
    m, ssl, ss = 300, 700, 20
    unit = rng.integers(0, 4, m, dtype=np.int8)
    code = np.tile(unit, 4)[:ss + ssl + m + 40].copy()
    n_mask = np.zeros(code.shape[0], dtype=bool)
    ssl_pad, m_pad = vd.bucket_of(ssl, m)
    arrs = vd._pack_bucket(code, n_mask, [(ss, ssl, m)], ssl_pad, m_pad)
    got = vd._count_table(*(torch.from_numpy(a) for a in arrs[:4]),
                          m_pad=m_pad, R_pad=ssl_pad, B_pad=ssl_pad + 8)
    want = _count_table_np(arrs[0][0], arrs[1][0], m, ssl, ssl_pad,
                           ssl_pad + 8)
    assert int(got.max()) == m and (want == m).sum() > 0
    assert (want % 2 == 1).any() and (want > 256).sum() > 100
    assert np.array_equal(got[0].numpy().astype(np.int64), want)
    run = (ss, ssl, m)
    for impl in IMPLS:
        assert vd.vote_longer_batch(code, n_mask, [run], impl=impl,
                                    device="cpu") == [
            _c_index(code, n_mask, run)]
