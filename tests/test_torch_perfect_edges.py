"""The port's dense masks on planted perfect runs
(chip_smoke.perfect_edge_plan): eq runs of exactly cutoff - 1, cutoff and
cutoff + 1 on shift m, across a tile edge of the dense kernel, a word edge
and from the last bit of a word, at position 0, ending at L - 1 and cut by
one N.  The plain version's ps and pm planes (masks_ref) are held bit for
bit against the JAX package's numpy spec (ribbit_tpu.scan_host:
perfect_runs on match_bitmaps, starts kept where the run reaches the
cutoff); chip_smoke.py holds the CUDA kernel against the plain version on
the same sequences at three configurations."""

import functools

import numpy as np
import pytest
import torch

from ribbit_tpu import scan_host
from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.encode import encode

import ribbit_tpu_torch.scan_events as se
import ribbit_tpu_torch.scan_masks as sm
from chip_smoke import DENSE_TILE, PERFECT_UNITS, cutoff, perfect_edge_plan

torch.set_num_threads(2)

CASES = {"default": dict(), "m4-M37": dict(min_motif=4, max_motif=37)}


@functools.cache
def _plan():
    return [(name, *encode(seq), runs)
            for name, seq, runs in perfect_edge_plan()]


def _spec(code, n_mask, cfg):
    """(ps, pm) bool [nmotifs, L] by the numpy spec."""
    eq = scan_host.match_bitmaps(code, cfg)
    r0 = cfg.min_motif - cfg.min_shift
    ps = np.zeros((cfg.nmotifs, code.shape[0]), bool)
    pm = np.zeros_like(ps)
    for k in range(cfg.nmotifs):
        starts, ends = scan_host.perfect_runs(eq[r0 + k], n_mask)
        m = cfg.min_motif + k
        ps[k, starts[ends - starts >= cutoff(m)]] = True
        pm[k] = eq[r0 + k] & ~n_mask
    return ps, pm


@pytest.mark.parametrize("name", list(CASES))
def test_masks_match_numpy_spec_on_planted_runs(name):
    cfg = RibbitConfig.create(**CASES[name])
    for case, code, n_mask, _ in _plan():
        c = torch.from_numpy(code.view(np.uint8))
        n = torch.from_numpy(n_mask.view(np.uint8))
        _, _, ps, pm = sm.masks(c, n, se.anchor_planes(c, cfg), cfg)
        want_ps, want_pm = _spec(code, n_mask, cfg)
        assert np.array_equal(pm.numpy().astype(bool), want_pm), case
        assert np.array_equal(ps.numpy().astype(bool), want_ps), case


@pytest.mark.parametrize("name", list(CASES))
def test_planted_runs_are_what_they_claim(name):
    """Each planted run is exactly k long on its shift m and a perfect run
    iff k >= cutoff(m), except the run of cutoff(m) + 1 cut by an N at
    offset cutoff(m) - 1, which is not.  On every motif of the
    configuration among PERFECT_UNITS, for k in cutoff(m) - 1, cutoff(m),
    cutoff(m) + 1: a run crosses a tile edge, one crosses a word edge and
    no tile edge, one starts at the last bit of a word, one starts at 0
    and one ends at L - 1."""
    cfg = RibbitConfig.create(**CASES[name])
    seen = set()
    for case, code, n_mask, runs in _plan():
        L = code.shape[0]
        eq = scan_host.match_bitmaps(code, cfg)
        ps, _ = _spec(code, n_mask, cfg)
        for m, a, k in runs:
            if not cfg.min_motif <= m <= cfg.max_motif:
                continue
            r, c = m - cfg.min_shift, cutoff(m)
            assert eq[r, a:a + k].all(), (case, m, a, k)
            assert a == 0 or not eq[r, a - 1], (case, m, a, k)
            assert a + k == L or not eq[r, a + k], (case, m, a, k)
            cut = n_mask[a:a + k].any()
            if cut:
                assert k == c + 1 and not n_mask[a:a + c - 1].any()
                assert n_mask[a + c - 1] and not ps[m - cfg.min_motif, a]
                seen.add((m, "cut"))
                continue
            assert ps[m - cfg.min_motif, a] == (k >= c), (case, m, a, k)
            crossed = [e for e in range(a + 1, a + k) if e % 32 == 0]
            if any(e % DENSE_TILE == 0 for e in crossed):
                seen.add((m, k, "tile"))
            elif crossed:
                seen.add((m, k, "word"))
            if a % 32 == 31:
                seen.add((m, k, "bit 31"))
            if a == 0:
                seen.add((m, k, "start"))
            if a + k == L:
                seen.add((m, k, "end"))
    for m in PERFECT_UNITS:
        if not cfg.min_motif <= m <= cfg.max_motif:
            continue
        c = cutoff(m)
        assert {(m, k, kind) for k in (c - 1, c, c + 1)
                for kind in ("tile", "word", "bit 31", "start", "end")} \
            <= seen, m
        assert (m, "cut") in seen, m
