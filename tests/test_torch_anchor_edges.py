"""The port's anchor planes on planted runs (chip_smoke.anchor_edge_plan):
eq runs of exactly k on shift m, for k at and around the anchor limits
[3, 2m), across word and tile edges, at position 0 and closing just
before, at and past L - m.  The plain version (anchor_planes_ref) is held
bit for bit against the JAX package's numpy spec (ribbit_tpu.scan_host);
chip_smoke.py holds the CUDA kernel against the plain version on the same
sequences at three configurations."""

import functools

import numpy as np
import pytest
import torch

from ribbit_tpu import scan_host
from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.encode import encode

import ribbit_tpu_torch.scan_events as se
from chip_smoke import ANCHOR_TILE, ANCHOR_UNITS, anchor_edge_plan

torch.set_num_threads(2)

CASES = {"default": dict(), "m4-M37": dict(min_motif=4, max_motif=37)}


@functools.cache
def _plan():
    return [(name, encode(seq)[0], runs)
            for name, seq, runs in anchor_edge_plan()]


@pytest.mark.parametrize("name", list(CASES))
def test_anchor_planes_match_numpy_spec_on_planted_runs(name):
    cfg = RibbitConfig.create(**CASES[name])
    for case, code, _ in _plan():
        L = code.shape[0]
        got = se.anchor_planes(torch.from_numpy(code.view(np.uint8)), cfg)
        want = scan_host.anchor_bitmaps(scan_host.match_bitmaps(code, cfg),
                                        cfg)
        assert np.array_equal(se.unpack_words(got, L).numpy(), want), case


@pytest.mark.parametrize("name", list(CASES))
def test_planted_runs_are_what_they_claim(name):
    """Each planted run is exactly k long on its shift m; it is an anchor
    iff 3 <= k < 2m and it closes before L - m.  On every shift of the
    configuration among ANCHOR_UNITS: runs of 2, 3 and 2m straddle a tile
    edge, a 64-word tile edge and a word edge; a run of every length
    starts at 0; runs of 2m - 1 close at L - m - 1 (an anchor), at L - m
    and past it (not)."""
    cfg = RibbitConfig.create(**CASES[name])
    edges, starts, ends = set(), set(), set()
    for case, code, runs in _plan():
        L = code.shape[0]
        eq = scan_host.match_bitmaps(code, cfg)
        an = scan_host.anchor_bitmaps(eq, cfg)
        for m, a, k in runs:
            if not cfg.min_shift <= m <= cfg.max_shift:
                continue
            r, hi = m - cfg.min_shift, L - m
            end = min(a + k, hi)
            assert eq[r, a:end].all(), (case, m, a, k)
            assert a == 0 or not eq[r, a - 1], (case, m, a, k)
            assert a + k >= hi or not eq[r, a + k], (case, m, a, k)
            anchor = 3 <= k < 2 * m and a + k < hi
            assert an[r, a:end].all() if anchor else not an[r, a:end].any()
            crossed = [e for e in range(a + 1, a + k) if e % 32 == 0]
            if case == "anchor edges":
                kind = ("tile" if any(e % ANCHOR_TILE == 0 for e in crossed)
                        else "64-word tile" if any(e % 2048 == 0
                                                   for e in crossed)
                        else "word" if crossed else None)
                edges.add((m, k, kind))
            elif a == 0:
                starts.add((m, k))
            elif k == 2 * m - 1:
                ends.add((m, a + k - hi, anchor))
    for m in ANCHOR_UNITS:
        if not cfg.min_shift <= m <= cfg.max_shift:
            continue
        assert {(m, k, e) for k in (2, 3, 2 * m)
                for e in ("tile", "64-word tile", "word")} <= edges, m
        assert {(m, k) for k in (2, 3, 2 * m - 1, 2 * m, 2 * m + 1)} \
            <= starts, m
        assert {(m, -1, True), (m, 0, False), (m, 1, False)} <= ends, m
