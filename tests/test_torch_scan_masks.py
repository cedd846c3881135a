"""The port's dense generation masks (ribbit_tpu_torch.scan_masks) against
the JAX package: the plain PyTorch version bit for bit against the four
Pallas kernels that compute the planes (scan_pallas_v4, K5;
scan_pallas_full, K6; scan_pallas_v3, K7; scan_pallas_v2, K8) run in
interpret mode, against the event words' bits at edge lengths, the device
epilogue's streams against scan_events_via_pallas, and the golden BED
through the C core.  Integer planes and streams: the tolerance is exact
equality.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it against
this plain version there."""

import numpy as np
import pytest
import torch

from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.encode import encode
from ribbit_tpu.fasta import read_fasta
from ribbit_tpu.sim import simulate

import ribbit_tpu_torch.scan_events as se
import ribbit_tpu_torch.scan_masks as sm
from ribbit_tpu_torch.core import CoreSession

torch.set_num_threads(2)

# the configurations and inputs of tests/test_pallas.py:108-173
CASES = {"default": (dict(), 7), "m4-M37": (dict(min_motif=4, max_motif=37),
                                            8)}
EDGE_LENGTHS = (1, 7, 8, 101, 102, 103, 4097)


def _cfg(name):
    return RibbitConfig.create(**CASES[name][0])


def _case_input(name):
    sim = simulate(num_loci=2, seed=CASES[name][1], name="v4",
                   n_block_rate=0.5)
    return encode(sim.sequence)


def _tensors(code, n_mask):
    return (torch.from_numpy(code.view(np.uint8)),
            torch.from_numpy(n_mask.view(np.uint8)))


def _ref_planes(code, n_mask, cfg):
    c, n = _tensors(code, n_mask)
    return [p.numpy() for p in
            sm.masks_ref(c, n, se.anchor_planes_ref(c, cfg), cfg)]


def _assert_planes(got, want):
    for name, a, b in zip(sm.PLANES, got, want):
        b = np.asarray(b)
        assert a.dtype == np.int8 and a.shape == b.shape, name
        assert np.array_equal(a, b.astype(np.int8)), name


def test_masks_ref_matches_pallas_k5(cpu_jax):
    """scan_pallas_v4 in interpret mode, with its and the anchor pass's
    tile patched to 8192 and restored as tests/test_pallas.py does (the
    kernel algebra is tile-independent)."""
    import ribbit_tpu.scan_events_pallas as ev
    import ribbit_tpu.scan_pallas_v4 as m

    cfg = _cfg("default")
    code, n_mask = _case_input("default")
    saved = (m.TILE, m.EXT, m.CHUNK, ev.TILE, ev.EXT, ev.CHUNK)
    m.TILE = ev.TILE = 8192
    m.EXT = m.LPAD + m.TILE + m.CAP + 128
    m.CHUNK = m.LPAD + m.TILE + m.RPAD
    ev.EXT = ev.LPAD + ev.TILE + ev.CAP + 128
    ev.CHUNK = ev.LPAD + ev.TILE + ev.RPAD
    try:
        want = m.generate_masks_pallas_v4(code, n_mask, cfg, interpret=True)
    finally:
        m.TILE, m.EXT, m.CHUNK, ev.TILE, ev.EXT, ev.CHUNK = saved
        cpu_jax.clear_caches()   # drop traces of the patched geometry
    got = _ref_planes(code, n_mask, cfg)
    _assert_planes(got, want)
    assert all(p.any() for p in got)


@pytest.fixture(scope="module")
def k6_case(cpu_jax):
    """-m 4 -M 37 (min_shift 2, the overlay's neighbours clip at the
    shift range): K6's planes and scan_events_via_pallas's streams, one
    interpret compile shared by both."""
    from ribbit_tpu.scan_pallas_full import (generate_masks_pallas,
                                             scan_events_via_pallas)
    cfg = _cfg("m4-M37")
    code, n_mask = _case_input("m4-M37")
    return (code, n_mask, cfg,
            generate_masks_pallas(code, n_mask, cfg, interpret=True),
            scan_events_via_pallas(code, n_mask, cfg, interpret=True))


def test_masks_ref_matches_pallas_k6(k6_case):
    code, n_mask, cfg, want, _ = k6_case
    got = _ref_planes(code, n_mask, cfg)
    _assert_planes(got, want)
    assert all(p.any() for p in got)


def test_streams_match_scan_events_via_pallas(k6_case):
    code, n_mask, cfg, _, want = k6_case
    got = sm.scan_events_via_masks(code, n_mask, cfg, device="cpu")
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            assert a.dtype == np.int64
            assert np.array_equal(a, np.asarray(b, np.int64))
        assert gs[0].shape[0] > 0


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kernel", ["v3", "v2"], ids=["K7", "K8"])
def test_masks_ref_matches_pallas_k7_k8(cpu_jax, kernel, name):
    """K7 (scan_pallas_v3, manual DMA) and K8 (scan_pallas_v2, shifts on
    sublanes) in interpret mode on tests/test_pallas.py:69-103's inputs:
    dense_masks serves both, so its plain version must equal their planes
    exactly."""
    import importlib
    fn = getattr(importlib.import_module(f"ribbit_tpu.scan_pallas_{kernel}"),
                 f"generate_masks_pallas_{kernel}")
    cfg = _cfg(name)
    code, n_mask = _case_input(name)
    got = _ref_planes(code, n_mask, cfg)
    _assert_planes(got, fn(code, n_mask, cfg, interpret=True))
    assert all(p.any() for p in got)


def _edge_input(L, all_n=False):
    rng = np.random.default_rng(L)
    if all_n:
        return encode("N" * L)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
    bases[rng.random(L) < 0.1] = ord("N")
    return encode(bases.tobytes().decode())


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("L", EDGE_LENGTHS + ("all-N",))
def test_masks_match_event_word_bits(name, L):
    """q7, q6 and pm of each motif row equal the bits of the event words
    (flagwords_ref) of its shift row."""
    cfg = _cfg(name)
    code, n_mask = _edge_input(300, all_n=True) if L == "all-N" \
        else _edge_input(L)
    c, n = _tensors(code, n_mask)
    a = se.anchor_planes_ref(c, cfg)
    q7, q6, ps, pm = (p.numpy() for p in sm.masks(c, n, a, cfg))
    uw = se.flagwords_ref(c, n, a, cfg).numpy().view(np.uint32)
    r0 = cfg.min_motif - cfg.min_shift
    for k in range(cfg.nmotifs):
        g, bit = divmod(r0 + k, se.OUT_ROWS)
        for plane, field in ((q6, 0), (q7, 1), (pm, 2)):
            assert np.array_equal(
                plane[k], ((uw[g] >> np.uint32(se._bit_of(bit, field)))
                           & 1).astype(np.int8))
    # every flag opens a pm run (pm[-1] counts as 0)
    prev = np.concatenate([np.zeros((cfg.nmotifs, 1), np.int8),
                           pm[:, :-1]], axis=1)
    assert not (ps & ~(pm & ~prev)).any()


def test_golden_bed_through_masks(golden_dir):
    """g3's events from the dense planes, replayed and refined by the C
    core, give the oracle's BED line for line."""
    from ribbit_tpu_torch.config import RibbitConfig as PortConfig
    cfg = PortConfig.create()
    lines = []
    for sid, seq in read_fasta(str(golden_dir / "g3.fa")):
        code, n_mask = encode(seq)
        sess = CoreSession(code, n_mask, cfg)
        try:
            sess.set_events(*sm.scan_events_via_masks(code, n_mask, cfg,
                                                      device="cpu"))
            lines += sess.refine(sess.scan(), seq, sid)
        finally:
            sess.close()
    assert lines == (golden_dir / "g3.oracle.bed").read_text().splitlines()


def test_generate_masks_contract():
    """numpy int8 [nmotifs, L] planes; the wrapper on CPU tensors is the
    plain version."""
    cfg = _cfg("m4-M37")
    code, n_mask = _edge_input(700)
    got = sm.generate_masks(code, n_mask, cfg, device="cpu")
    assert [p.shape for p in got] == [(cfg.nmotifs, 700)] * 4
    _assert_planes(got, _ref_planes(code, n_mask, cfg))


def test_no_fallback_without_cuda():
    """device="cuda" without CUDA raises; nothing runs on the host
    instead."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the absent-CUDA error cannot occur")
    code, n_mask = _edge_input(300)
    cfg = _cfg("default")
    with pytest.raises(RuntimeError, match="is_available"):
        sm.generate_masks(code, n_mask, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        sm.scan_events_via_masks(code, n_mask, cfg)
