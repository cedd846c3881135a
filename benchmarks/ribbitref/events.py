"""Scanner replays: turn per-channel run/window structures into the exact
sequence of lattice insertions the reference's position-sweep scanners make.

The reference sweeps sequence positions once, updating per-channel state
machines and calling addSeedToSeedPositions* mid-sweep; insertion ORDER
matters because the lattices are order-dependent.  Every insertion happens at
a well-defined (position, channel) moment, so we reconstruct the global order
from compact per-channel run lists (computed on device or with numpy) and
replay insertions sorted by (position, channel, tie) — an exact but
data-sparse equivalent of the reference's O(NSHIFTS * L) sweeps:

  - perfect scanner      processShiftXORsPerfect (parse_perfect_shiftxor.cpp:146-226)
  - substitution scanner processShiftXORswithSubstitutions
                         (parse_substitute_shiftxor.cpp:391-577)
  - anchored scanner     processShiftXORsAnchored (parse_anchored_shiftxor.cpp:538-726)

The benchmark's frozen copy of the repository's events.py spec.
"""

from __future__ import annotations

import bisect
from typing import List

import numpy as np

from .config import RibbitConfig, RANK_S, RANK_A, WINDOW_LENGTH
from . import lattice
from .scan_host import _runs, perfect_runs


# ---------------------------------------------------------------------------
# Perfect scanner
# ---------------------------------------------------------------------------

def run_perfect_scan(eq: np.ndarray, n_mask: np.ndarray, bitcount,
                     cfg: RibbitConfig) -> List[lattice.Seed]:
    """Replay processShiftXORsPerfect.  eq: raw match bitmaps [NSHIFTS, L]."""
    L = n_mask.shape[0]
    events = []  # (emit_pos, didx, start, end, closed_by_n)

    for didx in range(cfg.nmotifs):
        m = cfg.min_motif + didx
        midx = cfg.motif_channel(m)
        starts, ends = perfect_runs(eq[midx], n_mask)
        cutoff = 12 - m if m <= 6 else m
        # QUIRK: runs closed by an N use cutoff m + midx (= 2m - min_shift);
        # inconsistent with the normal branch (parse_perfect_shiftxor.cpp:179 vs 193)
        cutoff_n = 12 - m if m <= 6 else m + midx
        for s, e in zip(starts.tolist(), ends.tolist()):
            if e >= L:  # run reaches sequence end
                # final flush uses window_position = L-1 (parse_perfect_shiftxor.cpp:213)
                if (L - 1) - s >= cutoff:
                    events.append((L, didx, s, L - 1))
            elif n_mask[e]:
                if e - s >= cutoff_n:
                    events.append((e, didx, s, e))
            else:
                if e - s >= cutoff:
                    events.append((e, didx, s, e))

    events.sort(key=lambda t: (t[0], t[1]))
    seeds: List[lattice.Seed] = []
    for _pos, didx, s, e in events:
        m = cfg.min_motif + didx
        lattice.add_seed_perfect(s, e, m, seeds, bitcount, L, cfg)
    return seeds


# ---------------------------------------------------------------------------
# Windowed scanners (substitution & anchored share the state machine)
# ---------------------------------------------------------------------------

def _segments(n_mask: np.ndarray) -> List[tuple[int, int]]:
    """Maximal N-free intervals [a, b) of the sequence."""
    starts, ends = _runs(~n_mask)
    return list(zip(starts.tolist(), ends.tolist()))


def _windowed_emissions(qual_channel: np.ndarray, segments: List[tuple[int, int]],
                        L: int, m: int, didx: int) -> List[tuple]:
    """Replay one channel of the windowed scanner state machine.

    qual_channel: int8[L-7] (+1 qualified / 0 evaluated-unqualified / -1 skipped).
    Returns emissions (key_pos, didx, sub, start, end); key_pos==L means the
    end-of-sequence flush (which uses end = L, parse_substitute_shiftxor.cpp:540).
    """
    W = WINDOW_LENGTH
    emissions: List[tuple] = []

    # qualified-window runs [ws, we] inclusive (within evaluated regions)
    qstarts, qends = _runs(qual_channel == 1)
    if qstarts.size == 0:
        return emissions

    # evaluated-window intervals per segment: w in [segA, segB-W]
    wide = [(a, b) for a, b in segments if b - a >= W]
    eval_lo = [a for a, _ in wide]
    eval_hi = [b - W for _, b in wide]
    seg_b = [b for _, b in wide]
    n_wide = len(wide)

    def first_eval_after(x: int) -> int:
        """Smallest evaluated window index >= x+1, or a sentinel past the end."""
        j = bisect.bisect_left(eval_hi, x + 1)
        if j >= n_wide:
            return 1 << 60
        lo = eval_lo[j]
        return x + 1 if x + 1 > lo else lo

    cur = -1          # current tracked seed start (window index) or -1
    ls = le = -1      # last saved seed [ls, le)

    for ws, we_excl in zip(qstarts.tolist(), qends.tolist()):
        we = we_excl - 1  # inclusive last qualified window

        # between the previous close and this run start, the first evaluated
        # window w with w > le flushes the saved seed (if it precedes ws)
        if le != -1:
            wf = first_eval_after(le)
            if wf < ws:
                emissions.append((wf + W - 1, didx, 0, ls, le))
                ls = le = -1

        # run start (scan position ws + W - 1)
        if le != -1 and le < ws:
            emissions.append((ws + W - 1, didx, 0, ls, le))
            ls = le = -1
        cur = ws

        # locate this run's segment to classify the close
        si = bisect.bisect_left(eval_hi, we)
        seg_last_eval = eval_hi[si]
        if we < seg_last_eval:
            # closed by an evaluated below-threshold window at we+1
            if ls == -1:
                ls = cur
            le = we + W            # end = (we+1) + W - 1, exclusive
            cur = -1
        else:
            segB = seg_b[si]
            if segB < L:
                # an N at segB: the tracked seed is DROPPED; flush check uses
                # window_position = segB - (W - 1)
                # (parse_substitute_shiftxor.cpp:433-454)
                if le != -1 and le < segB - (W - 1):
                    emissions.append((segB, didx, 0, ls, le))
                    ls = le = -1
                cur = -1
            # else: sequence end with cur still tracking -> EOF logic below

    # after the final run: a late evaluated window may still flush `last`
    if le != -1 and cur == -1:
        wf = first_eval_after(le)
        if wf < (1 << 60):
            emissions.append((wf + W - 1, didx, 0, ls, le))
            ls = le = -1

    # end-of-sequence flush (parse_substitute_shiftxor.cpp:534-574); end = L
    if le == -1:
        if cur != -1:
            emissions.append((L, didx, 0, cur, L))
    else:
        if cur == -1:
            emissions.append((L, didx, 0, ls, le))
        else:
            if le >= cur - m:
                emissions.append((L, didx, 0, ls, L))
            else:
                emissions.append((L, didx, 0, ls, le))
                emissions.append((L, didx, 1, cur, L))

    return emissions


def collect_window_emissions(qual: np.ndarray, n_mask: np.ndarray,
                             cfg: RibbitConfig) -> List[tuple]:
    """All channels' windowed-scanner emissions in global scan order."""
    L = n_mask.shape[0]
    segments = _segments(n_mask)
    events: List[tuple] = []
    for didx in range(cfg.nmotifs):
        m = cfg.min_motif + didx
        midx = cfg.motif_channel(m)
        events.extend(_windowed_emissions(qual[midx], segments, L, m, didx))
    events.sort(key=lambda t: (t[0], t[1], t[2]))
    return events


def run_substitution_scan(qual: np.ndarray, n_mask: np.ndarray, bitcount,
                          perfect: List[lattice.Seed],
                          cfg: RibbitConfig) -> List[lattice.Seed]:
    """Replay processShiftXORswithSubstitutions over precomputed window
    qualification masks (threshold 7, raw bitmaps)."""
    L = n_mask.shape[0]
    seedlen_cutoffs = [(m // 3 if m > 30 else 10)
                       for m in range(cfg.min_motif, cfg.max_motif + 1)]
    substut: List[lattice.Seed] = []
    from_index = 0
    for _pos, didx, _sub, s, e in collect_window_emissions(qual, n_mask, cfg):
        m = cfg.min_motif + didx
        from_index = lattice.add_seed_substitution(
            s, e, m, perfect, substut, seedlen_cutoffs, bitcount, L,
            from_index, RANK_S, cfg)
    return substut


def run_anchored_scan(qual: np.ndarray, n_mask: np.ndarray, bitcount,
                      perfect: List[lattice.Seed], substut: List[lattice.Seed],
                      cfg: RibbitConfig) -> List[lattice.Seed]:
    """Replay processShiftXORsAnchored over the overlay window masks
    (threshold 6).  Cutoffs per parse_anchored_shiftxor.cpp:572-573."""
    L = n_mask.shape[0]
    seedlen_cutoffs = []
    for m in range(cfg.min_motif, cfg.max_motif + 1):
        c = m if m > 6 else 10
        if m >= 10:
            c = int(0.9 * m)
        seedlen_cutoffs.append(c)

    anchored: List[lattice.Seed] = []
    from_indices = (0, 0)
    events = collect_window_emissions(qual, n_mask, cfg)
    n_events = len(events)
    for k, (_pos, didx, _sub, s, e) in enumerate(events):
        m = cfg.min_motif + didx
        if _pos < L:
            from_indices = lattice.add_seed_anchored(
                s, e, m, perfect, substut, anchored, seedlen_cutoffs,
                bitcount, L, from_indices, RANK_A, cfg)
        else:
            # QUIRK: in the reference's end-of-sequence flush only the
            # "save both separately" first call updates from_indices
            # (parse_anchored_shiftxor.cpp:713 vs 688/697/706/717)
            new_fi = lattice.add_seed_anchored(
                s, e, m, perfect, substut, anchored, seedlen_cutoffs,
                bitcount, L, from_indices, RANK_A, cfg)
            if _sub == 0 and k + 1 < n_events and events[k + 1][1] == didx \
                    and events[k + 1][2] == 1:
                from_indices = new_fi
    return anchored
