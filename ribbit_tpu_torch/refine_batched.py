"""Device-batched refinement: seed alignment scoring on the GPU.

The port of ribbit_tpu/refine_batched.py.  Alternative to the C core's
threaded refinement: the per-seed Smith-Waterman forward/reverse scoring
passes, the O(len^2) core of refinement, run as BATCHES through the CUDA
kernels of align_kernels (ssw_forward_small for pairs within fits(),
ssw_forward_large for the rest), with the O(len*band) banded traceback,
CIGAR processing and emission on the host (the Python spec modules).
Output is exactly the sequential path's: work items carry hierarchical
order keys (seed index, then recursion path), and process_seed's flank
recursion becomes rounds of pending items assembled depth-first.

The forward passes run on `device` (cuda by default; cpu runs the kernels'
plain PyTorch version), or on a list of devices: the fits() pairs then
split over the list (parallel/sharded_refine.py, the counterpart of the
JAX package's mesh-sharded forward, which it passed in as
forward_override) and the oversized pairs run on the first device.  Not
ported: use_device=False (pair-by-pair numpy alignment), which no caller
of the port uses.  The host traceback (align.banded_sw, pure Python)
dominates this route's time, so the C pool stays the pipeline's default
and this route runs when RIBBIT_BATCHED_REFINE is set.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .config import RibbitConfig, CONTINUOUS_ONES_THRESHOLD
from . import align_kernels, bitutils
from .align import _TRANSLATE, banded_sw, _mark_mismatch, Alignment
from .cigarproc import process_cigar_with_pruning, process_cigar_motifwise
from .parallel.sharded_refine import batch_forward_sharded
from .refine import (format_purity, _ppr_length, _build_ppr,
                     _n_trimmed_length, most_frequent_longer_motif,
                     possible_motifs, calculate_motif_units)


def _translate_codes(s: str) -> np.ndarray:
    raw = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
    return _TRANSLATE[raw & 0x7F]


def _batch_forward_split(reads, refs, terms, device):
    """Dispatch a forward batch across the two kernels: ssw_forward_small
    (a warp per pair) for pairs within fits(), split over `device` when it
    is a list, and ssw_forward_large (a block per pair) for oversized
    pairs, on the list's first device, as the JAX package splits them
    between its two Pallas kernels.  Returns per-pair (score, end_ref,
    end_read, first_hit) in the input order."""
    devices = (list(device) if isinstance(device, (list, tuple))
               else [device])
    n = len(reads)
    small = [i for i in range(n)
             if align_kernels.fits(reads[i].shape[0], refs[i].shape[0])]
    score = np.empty(n, np.int64)
    end_ref = np.empty(n, np.int64)
    end_read = np.empty(n, np.int64)
    first_hit = np.empty(n, np.int64)

    def run(idx, forward):
        if not idx:
            return
        t = None if terms is None else [terms[i] for i in idx]
        s, er, erd, fh = forward([reads[i] for i in idx],
                                 [refs[i] for i in idx], t)
        score[idx] = s
        end_ref[idx] = er
        end_read[idx] = erd
        first_hit[idx] = fh

    run(small, lambda r, f, t: batch_forward_sharded(r, f, t, devices))
    if len(small) != n:
        small_set = set(small)
        run([i for i in range(n) if i not in small_set],
            lambda r, f, t: align_kernels.forward(
                align_kernels.ssw_forward_large, r, f, t, devices[0]))
    return score, end_ref, end_read, first_hit


def _device_align(pairs: List[Tuple[np.ndarray, np.ndarray]],
                  device) -> List[Optional[Alignment]]:
    """Exact Align() for a batch of (read, ref) code pairs: device forward +
    device reverse (terminate mode), host banded traceback + '='/'X' split.
    Equivalent to ribbit_tpu/align.py ssw_align pair-by-pair."""
    out: List[Optional[Alignment]] = [None] * len(pairs)
    live = [i for i, (rd, rf) in enumerate(pairs)
            if rd.shape[0] and rf.shape[0]]
    if not live:
        return out
    reads = [pairs[i][0] for i in live]
    refs = [pairs[i][1] for i in live]
    score, end_ref, end_read, _ = _batch_forward_split(
        reads, refs, None, device)

    rev_idx = []
    rev_reads, rev_refs, terms = [], [], []
    for k, i in enumerate(live):
        if end_ref[k] < 0:
            al = Alignment()
            al.sw_score = 0
            al.ref_end = -1
            al.query_end = pairs[i][0].shape[0] - 1
            out[i] = al                      # empty cigar -> caller skips
            continue
        rev_idx.append((k, i))
        rev_reads.append(pairs[i][0][:int(end_read[k]) + 1][::-1].copy())
        rev_refs.append(pairs[i][1][:int(end_ref[k]) + 1][::-1].copy())
        terms.append(int(score[k]))
    if rev_idx:
        _s2, _er2, erd2, hit2 = _batch_forward_split(
            rev_reads, rev_refs, terms, device)
        for j, (k, i) in enumerate(rev_idx):
            read, ref = pairs[i]
            al = Alignment()
            al.sw_score = int(score[k])
            al.ref_end = int(end_ref[k])
            al.query_end = int(end_read[k])
            al.ref_begin = al.ref_end - int(hit2[j])
            al.query_begin = al.query_end - int(erd2[j])
            sub_ref = ref[al.ref_begin:al.ref_end + 1]
            sub_read = read[al.query_begin:al.query_end + 1]
            band_width = abs(sub_ref.shape[0] - sub_read.shape[0]) + 1
            ops = banded_sw(sub_ref, sub_read, al.sw_score, band_width)
            al.cigar_string, al.mismatches = _mark_mismatch(
                al, ref, read, read.shape[0], ops)
            out[i] = al
    return out


def refine_batched(seeds: np.ndarray, sequence: str, sequence_id: str,
                   code: np.ndarray, n_mask: np.ndarray, sess,
                   cfg: RibbitConfig, device="cuda") -> List[str]:
    """Refine the merged seed stream with batched alignment rounds.

    sess: CoreSession (overlay longest-run queries).  The forward passes
    run on `device`, or split over a list of devices (_batch_forward_split).  Returns BED lines in the sequential path's exact
    order (hierarchical order keys)."""
    L = len(sequence)
    translated = _translate_codes(sequence)
    results: List[Tuple[tuple, str]] = []    # (order_key, line)

    # pending large-motif work items: (key, seed_start, seed_end, mlen,
    # seed_type, midx); motifwise items carry their candidate list
    pending: List[tuple] = []
    for idx, (s, e, mlen, rank) in enumerate(seeds.tolist()):
        if rank == -1:
            continue
        if e - s >= 0.9 * mlen:
            pending.append(((idx,), s, e, mlen, rank,
                            cfg.motif_channel(mlen)))

    while pending:
        requests: List[tuple] = []           # per-item alignment request ctx
        pairs: List[Tuple[np.ndarray, np.ndarray]] = []

        for item in pending:
            key, seed_start, seed_end, mlen, seed_type, midx = item
            ssl = _n_trimmed_length(n_mask, seed_start, seed_end, mlen)
            if mlen <= 10:
                if sess.overlay_longest_run(midx, seed_start, seed_end) \
                        < CONTINUOUS_ONES_THRESHOLD:
                    continue
                motifs, starts, ends = possible_motifs(code, seed_start, ssl,
                                                       mlen, L, cfg)
                for ci in range(len(motifs)):
                    motif_unit = motifs[ci]
                    atom = bitutils.atomicity(motif_unit, mlen)
                    motif = bitutils.motif_to_string(motif_unit, mlen)[:atom]
                    unit = motif_unit >> (2 * (mlen - atom))
                    ms, me = starts[ci], ends[ci]
                    msl = me - ms
                    ppr = _build_ppr(motif, _ppr_length(msl, mlen))
                    requests.append((key + (ci,), "small", seed_start, ms,
                                     msl, mlen, seed_type, atom, motif, unit,
                                     None, None))
                    pairs.append((translated[ms:me].copy(),
                                  _translate_codes(ppr)))
            else:
                if seed_end - seed_start < 0.9 * mlen:
                    continue
                if sess.overlay_longest_run(midx, seed_start, seed_end) \
                        < CONTINUOUS_ONES_THRESHOLD:
                    continue
                ppr_len = _ppr_length(ssl, mlen)
                unit = most_frequent_longer_motif(code, n_mask, seed_start,
                                                  ssl, mlen, L)
                atom = bitutils.atomicity_long(unit, mlen)
                if mlen % atom != 0:
                    continue
                motif = bitutils.motif_to_string(unit, mlen)[:atom]
                ppr = _build_ppr(motif, ppr_len)
                read = translated[seed_start:seed_start + ssl].copy()
                requests.append((key, "large", seed_start, seed_start, ssl,
                                 mlen, seed_type, atom, motif, unit,
                                 seed_end, midx))
                pairs.append((read, _translate_codes(ppr)))

        aligns = _device_align(pairs, device)

        pending = []
        for req, al in zip(requests, aligns):
            (key, kind, seed_start, a_start, a_len, mlen, seed_type, atom,
             motif, unit, seed_end, midx) = req
            if al is None or not al.cigar_string:
                continue
            if kind == "small":
                values, cigar, purity = process_cigar_motifwise(
                    a_start, a_len, al.cigar_string, atom)
                rs, re, _alen, _mu = values
                rl = re - rs
                match_units = calculate_motif_units(code, rs, rl, atom, L,
                                                    unit)
                if match_units >= cfg.n_perfect_units(atom) and \
                        rl >= cfg.min_length(atom):
                    results.append((key, "\t".join((
                        sequence_id, str(rs), str(re), motif,
                        f"{atom} | {mlen}", str(rl), str(rl // atom),
                        format_purity(purity), "+", f"SEED-{seed_type}",
                        cigar))))
            else:
                values, cigar, purity = process_cigar_with_pruning(
                    a_start, a_len, al.cigar_string, atom,
                    cfg.minimum_length)
                rs, re, alen, _mu = values
                loci_first, loci_second = rs, re - atom
                if alen >= cfg.min_length(atom):
                    rl = re - rs
                    if rl >= cfg.min_length(mlen):
                        results.append((key, "\t".join((
                            sequence_id, str(rs), str(re), motif,
                            f"{atom} | {mlen}", str(rl), str(rl // atom),
                            format_purity(purity), "+",
                            f"SEED-{seed_type}", cigar))))
                # flank recursion (parse_seed.cpp:444-463): children sort
                # after the parent's emission via extended keys
                flank_start = seed_start
                child = 0
                first, second = loci_first, loci_second
                if flank_start >= first:
                    flank_start = second
                else:
                    if first - flank_start >= cfg.min_length(mlen):
                        if flank_start < seed_start:
                            flank_start = seed_start
                        if first > seed_end:
                            first = seed_end
                        if not (flank_start == seed_start
                                and first == seed_end):
                            pending.append((key + (child,), flank_start,
                                            first, mlen, seed_type, midx))
                            child += 1
                    flank_start = second
                if seed_end - flank_start >= cfg.min_length(mlen):
                    if flank_start < seed_start:
                        flank_start = seed_start
                    if flank_start != seed_start:
                        pending.append((key + (child,), flank_start,
                                        seed_end, mlen, seed_type, midx))

    results.sort(key=lambda kv: kv[0])
    return [line for _k, line in results]
