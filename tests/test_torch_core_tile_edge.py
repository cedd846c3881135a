"""A known fault of the shared C core's host generation, pinned.

csrc/ribbit_core.c's cache-blocked generation pass works in tiles of
GEN_TS = 65,536 positions.  A perfect run that starts 1-5 positions before
a tile's end is cut to start at the tile's end: its 6-run probe ends past
the tile, so the carry into the next tile never fires.  The port's device
extractor has no such tiles.  Here, on one contig with such a run before
each of five tile ends (and a control 6 positions before a sixth), the
port's extractor on the CPU (scan_events_device, the plain versions of
both kernels) equals the port's numpy spec (scan_host), and the C host
generation (capture_runs_host) differs from it by exactly the cut runs.
A fix of the shared core shows here as a failing expectation."""

import functools

import numpy as np
import torch

from ribbit_tpu_torch import scan_host
from ribbit_tpu_torch import scan_events as se
from ribbit_tpu_torch.config import RibbitConfig
from ribbit_tpu_torch.encode import encode
from ribbit_tpu_torch.eventstitch import capture_runs_host

torch.set_num_threads(2)

GEN_TS = 1 << 16            # csrc/ribbit_core.c's generation tile
MOTIF, RUN = 9, 30          # a perfect run of 30 on shift 9 (cutoff 9)
OFFSETS = (1, 2, 3, 4, 5, 6)   # start this far before tile ends 1..6


@functools.cache
def _contig():
    """(code, n_mask, cfg, planted runs, port streams, C streams)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, GEN_TS * len(OFFSETS) + 1000)
    planted = {}
    for t, d in enumerate(OFFSETS, start=1):
        a = GEN_TS * t - d
        unit = rng.integers(0, 4, MOTIF)
        n = MOTIF + RUN
        codes[a:a + n] = unit[np.arange(n) % MOTIF]
        codes[a - 1] = (unit[MOTIF - 1] + 1) % 4     # eq[a - 1] = 0
        codes[a + n] = (unit[RUN % MOTIF] + 1) % 4   # eq[a + RUN] = 0
        planted[d] = (a, a + RUN)
    seq = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    code, n_mask = encode(seq)
    cfg = RibbitConfig.create()
    port = se.scan_events_device(code, n_mask, cfg, device="cpu")
    return code, n_mask, cfg, planted, port, capture_runs_host(code, n_mask,
                                                               cfg)


def _channel(streams, ch):
    s, e, o = streams[0]                      # the perfect stream
    return set(zip(s[o[ch]:o[ch + 1]].tolist(), e[o[ch]:o[ch + 1]].tolist()))


def _spec(code, n_mask, cfg):
    eq = scan_host.match_bitmaps(code, cfg)[MOTIF - cfg.min_shift]
    s, e = scan_host.perfect_runs(eq, n_mask)
    keep = e - s >= MOTIF                     # cutoff: m for m > 6
    return set(zip(s[keep].tolist(), e[keep].tolist()))


def test_port_extractor_equals_numpy_spec_at_tile_ends():
    code, n_mask, cfg, planted, port, _ = _contig()
    got = _channel(port, MOTIF - cfg.min_motif)
    assert got == _spec(code, n_mask, cfg)
    assert set(planted.values()) <= got


def test_c_generation_differs_only_by_the_cut_runs():
    """Shifts 9 and 18 (the planted unit twice: runs of 21) lose the five
    runs that start 1-5 positions before a tile end, each reported from
    the tile's end instead, or dropped where that rest is shorter than
    the cutoff; every other channel and both window streams agree with
    the port."""
    _, _, cfg, planted, port, cap = _contig()
    for c in range(cfg.nmotifs):
        m = cfg.min_motif + c
        got, want = _channel(cap, c), _channel(port, c)
        lost = want - got
        cutoff = 12 - m if m <= 6 else m
        cut = {(GEN_TS * (s // GEN_TS + 1), e) for s, e in lost}
        assert got - want == {(s, e) for s, e in cut if e - s >= cutoff}, m
        assert all(GEN_TS - s % GEN_TS <= 5 for s, _ in lost), m
        if m == MOTIF:
            assert lost == {planted[d] for d in OFFSETS if d <= 5}
        else:
            assert len(lost) == (5 if m == 2 * MOTIF else 0), m
    for k in (1, 2):
        for a, b in zip(port[k], cap[k]):
            assert np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64)), k
