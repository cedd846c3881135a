"""The port's event extraction (ribbit_tpu_torch.scan_events) against the
JAX package: the plain PyTorch versions of both kernels bit for bit against
the Pallas kernels run in interpret mode, against the numpy spec
(ribbit_tpu.scan_host) at edge lengths, and the decoded streams against
the JAX extractor.  Integer bit planes: the tolerance is exact equality.

The CUDA kernels themselves run only on a card; chip_smoke.py holds them
against these plain versions there."""

import numpy as np
import pytest
import torch

from ribbit_tpu import scan_host
from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.encode import encode
from ribbit_tpu.sim import simulate

import ribbit_tpu_torch.scan_events as se
from chip_smoke import EDGE_LENGTHS, poly_a_n

torch.set_num_threads(2)

# the two configurations (and inputs) of tests/test_events_pallas.py
CASES = {"default": (dict(), 7, 0.3),
         "m4-M37": (dict(min_motif=4, max_motif=37), 8, 0.5)}


def _cfg(name):
    return RibbitConfig.create(**CASES[name][0])


def _case_seq(name):
    _, seed, nb = CASES[name]
    return simulate(num_loci=2, seed=seed, name="ev", n_block_rate=nb).sequence


def _tensors(code, n_mask):
    return (torch.from_numpy(code.view(np.uint8)),
            torch.from_numpy(n_mask.view(np.uint8)))


def _ov(cfg, L):
    """The event pass's packed overlay output for L positions."""
    return torch.empty(cfg.nmotifs, se.overlay_row_words(L), dtype=torch.int32)


@pytest.fixture(scope="module")
def pallas_ref(cpu_jax):
    """Per configuration: (code, n_mask, K1 anchor planes, K2 words) from
    the Pallas kernels in interpret mode, at the small tile of
    tests/test_events_pallas.py (the kernel algebra is tile-independent).
    One interpret run per configuration, shared by the tests below."""
    import jax.numpy as jnp
    import ribbit_tpu.scan_events_pallas as m

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m, "TILE", 4096)
        mp.setattr(m, "EXT", m.LPAD + 4096 + m.CAP + 128)
        mp.setattr(m, "CHUNK", m.LPAD + 4096 + m.RPAD)
        for name in CASES:
            cfg = _cfg(name)
            code, n_mask = encode(_case_seq(name))
            L = code.shape[0]
            comb = jnp.asarray(m._pad_inputs(code, n_mask))
            nsp = se.nsp_of(cfg)
            k1 = []
            for h in range((nsp + m.AROWS - 1) // m.AROWS):
                row0 = h * m.AROWS
                s_max = min(cfg.min_shift + row0 + m.AROWS - 1, cfg.max_shift)
                k1.append(np.asarray(m._anchor_rows(
                    comb, jnp.int32(L), rb=m.AROWS, row0=row0,
                    min_shift=cfg.min_shift, max_shift=cfg.max_shift,
                    lsteps=max(3, (2 * s_max - 1).bit_length()),
                    interpret=True))[0, :L])
            k2 = m.flagwords_pallas(code, n_mask, cfg, interpret=True)
            out[name] = (code, n_mask, np.stack(k1), k2)
    cpu_jax.clear_caches()   # drop traces captured at the patched geometry
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_anchor_planes_match_pallas_k1(pallas_ref, name):
    cfg = _cfg(name)
    code, n_mask, k1, _ = pallas_ref[name]
    c, _ = _tensors(code, n_mask)
    got = se.anchors_to_k1_layout(se.anchor_planes(c, cfg), len(code), cfg)
    assert np.array_equal(got.numpy(), k1)
    assert k1.any()


@pytest.mark.parametrize("name", list(CASES))
def test_event_words_match_pallas_k2(pallas_ref, name):
    cfg = _cfg(name)
    code, n_mask, _, k2 = pallas_ref[name]
    c, n = _tensors(code, n_mask)
    got = se.event_words(c, n, se.anchor_planes(c, cfg), cfg,
                         _ov(cfg, len(code))).numpy()
    assert got.dtype == np.int32 and got.shape == k2.shape
    assert np.array_equal(got, k2)
    # rows past the last shift: q7 and pm are zero, but q6 carries the
    # overlay of the last shifts' anchors exactly as the Pallas pass does
    uw = got.view(np.uint32)
    q6_past = 0
    for r in range(cfg.nshifts, se.nsp_of(cfg)):
        g, bit = divmod(r, se.OUT_ROWS)
        assert not ((uw[g] >> np.uint32(8 + bit)) & 1).any()
        assert not ((uw[g] >> np.uint32(16 + bit)) & 1).any()
        q6_past += int(((uw[g] >> np.uint32(bit)) & 1).sum())
    if name == "default":
        assert q6_past > 0


@pytest.mark.parametrize("name", list(CASES))
def test_streams_match_jax_extractor(pallas_ref, name):
    """The port's scan_events_device on CPU equals the JAX package's
    device extractor (Pallas words + its decoder)."""
    from ribbit_tpu.scan_events_pallas import _decode_c as jax_decode

    cfg = _cfg(name)
    code, n_mask, _, k2 = pallas_ref[name]
    want = jax_decode(k2, cfg)
    got = se.scan_events_device(code, n_mask, cfg, device="cpu")
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64))


@pytest.mark.parametrize("name", list(CASES))
def test_streams_match_scan_events_tpu(cpu_jax, name):
    """The port's scan_events_device on CPU equals the XLA extractor
    (scan_events_tpu.scan_events, which parallel/distributed.py shards),
    so it can serve that extractor's callers."""
    from ribbit_tpu import scan_events_tpu

    cfg = _cfg(name)
    code, n_mask = encode(_case_seq(name))
    want = scan_events_tpu.scan_events(code, n_mask, cfg)
    got = se.scan_events_device(code, n_mask, cfg, device="cpu")
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64))
    assert got[2][0].shape[0] > 0


def _edge_input(L, all_n=False):
    if all_n:
        return encode("N" * L)
    if L == "poly-A/N":
        return encode(poly_a_n())
    rng = np.random.default_rng(L)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
    bases[rng.random(L) < 0.1] = ord("N")
    return encode(bases.tobytes().decode())


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("L", EDGE_LENGTHS + ("poly-A/N", "all-N"))
def test_edge_lengths_match_numpy_spec(name, L):
    """The plain event words against the numpy spec at word edges, at the
    CUDA kernel's warp and tile edges, on poly-A runs with N at word edges
    and on all N; chip_smoke.py holds the kernel on the same inputs."""
    cfg = _cfg(name)
    case = L
    code, n_mask = _edge_input(300, all_n=True) if L == "all-N" \
        else _edge_input(L)
    L = code.shape[0]
    c, n = _tensors(code, n_mask)
    anch = se.anchor_planes(c, cfg)
    words = se.event_words(c, n, anch, cfg, _ov(cfg, L)).numpy() \
        .view(np.uint32)

    eq = scan_host.match_bitmaps(code, cfg)
    an = scan_host.anchor_bitmaps(eq, cfg)
    assert np.array_equal(se.unpack_words(anch, L).numpy(), an)
    ov = scan_host.overlay_bitmaps(eq, an, cfg)
    nw = max(L - 7, 0)

    def qual(bits, t):
        return scan_host.window_qualified(bits, n_mask, t)[:, :nw] == 1

    q7, q6 = qual(eq, 7), qual(ov, 6)
    for r in range(cfg.nshifts):
        g, bit = divmod(r, se.OUT_ROWS)
        field = [(words[g] >> np.uint32(f * 8 + bit)) & 1 for f in range(3)]
        assert np.array_equal(field[2], eq[r] & ~n_mask)           # pm
        assert np.array_equal(field[1][:nw], q7[r])                # q7
        assert not field[1][nw:].any() and not field[0][nw:].any()
        if cfg.min_motif <= cfg.min_shift + r <= cfg.max_motif:
            assert np.array_equal(field[0][:nw], q6[r])            # q6
    if case == "poly-A/N":
        # the case holds what it is for: every 8-window count of eq, and
        # N-free windows that begin and end at every offset of a word
        win = sum(np.pad(eq, ((0, 0), (0, 7)))[:, k:k + L] for k in range(8))
        assert set(np.unique(win)) == set(range(9))
        edges = np.diff(qual(np.ones_like(eq[:1]), 8)[0].astype(np.int8))
        for d in (1, -1):
            assert len(set((np.flatnonzero(edges == d) + 1) % 32)) == 32


def test_segmented_extraction_equals_whole_contig():
    """Stitched per-segment extraction (small segments, default halo)
    equals whole-contig extraction."""
    from ribbit_tpu.eventstitch import segment_bounds
    from ribbit_tpu_torch.pipeline import extract_events

    cfg = RibbitConfig.create()
    code, n_mask = encode(simulate(num_loci=8, seed=911, name="st").sequence)
    whole = se.scan_events_device(code, n_mask, cfg, device="cpu")
    assert len(segment_bounds(code.shape[0], 5000)) > 3
    seg = extract_events(code, n_mask, cfg, device="cpu", seg_size=5000)
    for w, s in zip(whole, seg):
        for a, b in zip(w, s):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64))
    assert len(whole[2][0]) > 0


def test_numpy_and_c_decoders_agree():
    cfg = RibbitConfig.create()
    code, n_mask = encode(simulate(num_loci=3, seed=19, name="dec",
                                   n_block_rate=0.2).sequence)
    w, _ov = se.flagwords(code, n_mask, cfg, device="cpu")
    for gs, ws in zip(se._decode_numpy(w, cfg), se._decode_c(w, cfg)):
        for a, b in zip(gs, ws):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    bits = torch.from_numpy(rng.random((3, 77)) < 0.5)
    words = se.pack_words(bits)
    assert words.dtype == torch.int32 and words.shape == (3, 3)
    assert torch.equal(se.unpack_words(words, 77), bits)
    allset = se.pack_words(torch.ones(32, dtype=torch.bool))
    assert int(allset[0]) == -1       # bit 31 set: two's complement int32


def test_wrappers_check_inputs_and_count_no_cpu_launches():
    cfg = RibbitConfig.create()
    code, n_mask = encode("ACGTN" * 40)
    c, n = _tensors(code, n_mask)
    a0, e0 = se.anchor_planes.launches, se.event_words.launches
    anch = se.anchor_planes(c, cfg)
    ov = _ov(cfg, len(code))
    se.event_words(c, n, anch, cfg, ov)
    # the plain versions ran: a CPU tensor never counts as a launch
    assert (se.anchor_planes.launches, se.event_words.launches) == (a0, e0)
    with pytest.raises(ValueError):
        se.anchor_planes(c.to(torch.int32), cfg)
    with pytest.raises(ValueError):
        se.anchor_planes(torch.zeros(0, dtype=torch.uint8), cfg)
    with pytest.raises(ValueError):
        se.event_words(c, n[:-1], anch, cfg, ov)
    with pytest.raises(ValueError):
        se.event_words(c, n, anch[:, :-1], cfg, ov)
    with pytest.raises(ValueError):
        se.event_words(c, n.bool(), anch, cfg, ov)
    with pytest.raises(ValueError):
        se.anchor_planes(torch.zeros(8, dtype=torch.uint8, device="meta"),
                         cfg)
    strided = torch.zeros(2 * len(code), dtype=torch.uint8)[::2]
    with pytest.raises(ValueError, match="strided"):
        se.anchor_planes(strided, cfg)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = RibbitConfig.create()
    code, n_mask = encode("ACGT" * 50)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        se.scan_events_device(code, n_mask, cfg, device="cuda")
