"""Device-batched refinement: seed alignment scoring on the GPU.

The port of ribbit_tpu/refine_batched.py, the JAX package's refinement
of a single-contig device run, which the port takes when
RIBBIT_BATCHED_REFINE is set (pipeline.py records why not by default).
It refines the merged seed stream in rounds; a round is:

  CoreSession.round_requests   the pending items' requests in C
                               (ribbit_tpu_torch/csrc/refine_rounds.c:
                               n-trim, overlay gate, possible_motifs or the
                               memoised C voter, the read and pseudo-perfect
                               ref of each request in flat buffers)
  align_kernels.pack_flat      one H2D of the round's reads and refs
  _forward                     the SSW forward passes: ssw_forward_small
                               (K3) for pairs within fits(), ssw_forward_large
                               (K4) for the rest
  _reverse_pairs               the located pairs' reversed prefixes,
                               gathered on the card
  _forward                     the terminate passes
  align.traceback_flat         the banded traceback of the located pairs
                               in C (ribbit_tpu_torch/csrc/traceback.c)
  CoreSession.round_emit       cigar processing, the BED lines and the
                               next round's items (process_seed's flank
                               recursion) in C

and no step loops over items in Python.  Output is exactly the
sequential path's: an item's key is its recursion path (seed index, then
child numbers), a line's key the path and its candidate, and _order sorts
every round's lines by key once at the end.  _requests and _emit are
the Python spec that the tests hold the C entries against; no route
calls them.  _device_align is _align_round over a list of pairs, which
the tests hold against the JAX package's ssw_align.

The forward passes run on `device` (cuda by default; cpu runs the kernels'
plain PyTorch version), or on a list of devices: the fits() pairs then
split over the list (parallel/sharded_refine.py, the counterpart of the
JAX package's mesh-sharded forward, which it passed in as
forward_override) and the oversized pairs run on the first device.  Not
ported: use_device=False (pair-by-pair numpy alignment), which no caller
of the port uses.  On an H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
6) the route refined chr21 (46.7 Mb) in 10.58 s against 11.48 s for the
C pool: request building 7.22 s (most of it the C voter), the traceback
1.53 s, emission 0.56 s, the SSW passes with their gathers 0.68 s.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .config import RibbitConfig, CONTINUOUS_ONES_THRESHOLD
from . import align_kernels, bitutils
from .align import _TRANSLATE, Alignment, traceback_flat
from .cigarproc import process_cigar_with_pruning, process_cigar_motifwise
from .native import get_traceback_lib
from .parallel.sharded_refine import forward_sharded
from .parallel.sharded_scan import make_mesh
from .refine import (format_purity, _ppr_length, _build_ppr,
                     _n_trimmed_length, most_frequent_longer_motif,
                     possible_motifs, calculate_motif_units)


def _translate_codes(s: str) -> np.ndarray:
    raw = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
    return _TRANSLATE[raw & 0x7F]


def _device_align(pairs: List[Tuple[np.ndarray, np.ndarray]],
                  device) -> List[Optional[Alignment]]:
    """Exact Align() for a list of (read, ref) code pairs: the pairs in
    flat buffers through _align_round, the route's alignment of a round.
    Equivalent to ribbit_tpu/align.py ssw_align pair by pair: None for an
    empty read or ref, an empty cigar where nothing was located."""
    reads, read_off, _ = align_kernels._concat([rd for rd, _ in pairs],
                                               len(pairs))
    refs, ref_off, _ = align_kernels._concat([rf for _, rf in pairs],
                                             len(pairs))
    devices = make_mesh(devices=device if isinstance(device, (list, tuple))
                        else [device])
    al = _align_round(reads.view(np.int8), read_off, refs.view(np.int8),
                      ref_off, devices, None)
    out: List[Optional[Alignment]] = [None] * len(pairs)
    for i, (rd, rf) in enumerate(pairs):
        if rd.shape[0] and rf.shape[0]:
            out[i] = Alignment()             # empty cigar -> caller skips
            out[i].sw_score = 0
            out[i].ref_end = -1
            out[i].query_end = rd.shape[0] - 1
    raw = al.cigar.tobytes()
    for j, i in enumerate(al.located.tolist()):
        o, k = int(al.cigar_off[j]), int(al.cigar_len[j])
        out[i] = Alignment(int(al.score[j]), int(al.ref_begin[j]),
                           int(al.ref_end[j]), int(al.query_begin[j]),
                           int(al.query_end[j]), raw[o:o + k].decode("ascii"),
                           int(al.mismatches[j]))
    return out


def _requests(pending: List[tuple], translated: np.ndarray,
              code: np.ndarray, n_mask: np.ndarray, sess,
              cfg: RibbitConfig):
    """One round's alignment requests: for each pending work item that
    passes its overlay check, the request context and the (read, ref)
    code pair to align (the seed or candidate stretch against its
    pseudo-perfect repeat).  Returns (requests, pairs)."""
    L = code.shape[0]
    requests: List[tuple] = []
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
    return requests, pairs


def _emit(requests: List[tuple], aligns: List[Optional[Alignment]],
          sequence_id: str, code: np.ndarray, cfg: RibbitConfig,
          results: List[Tuple[tuple, str]]) -> List[tuple]:
    """Process each request's cigar, append its BED line (with its order
    key) to results, and return the next round's pending items: the flank
    recursion of the large-motif requests."""
    L = code.shape[0]
    pending: List[tuple] = []
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
    return pending


def _forward(p: align_kernels.Pairs, devices) -> np.ndarray:
    """int64 [4, n] (score, end_ref, end_read, first_hit) of a batch on
    devices[0] (with terminate targets in p.term): the pairs within fits()
    through K3 (ssw_forward_small), split over the devices, the rest
    through K4 (ssw_forward_large) on the first, as the JAX package splits
    a batch between its two Pallas kernels."""
    small = align_kernels.fits(p.rlen, p.clen)
    out = np.empty((4, p.n), np.int64)
    idx = np.flatnonzero(small)
    if idx.size:
        out[:, idx] = forward_sharded(align_kernels.take(p, idx), devices)
    idx = np.flatnonzero(~small)
    if idx.size:
        out[:, idx] = align_kernels.forward_pairs(
            align_kernels.ssw_forward_large, align_kernels.take(p, idx),
            devices[0])
    return out


def _reverse_pairs(p: align_kernels.Pairs, located: np.ndarray,
                   fwd: np.ndarray) -> align_kernels.Pairs:
    """The terminate-mode pairs of the located pairs of p, gathered on p's
    device: each read and ref cut after its forward end and reversed (the
    [:end + 1][::-1] prefixes of ssw_align), the forward score its
    terminate target."""
    return align_kernels.take(p, located, fwd[2] + 1, fwd[1] + 1, fwd[0],
                              reverse=True)


class Aligned(NamedTuple):
    """The located alignments of a batch of pairs: pair located[k] has SW
    score score[k] over ref[ref_begin[k]..ref_end[k]] and
    read[query_begin[k]..query_end[k]], the cigar
    cigar[cigar_off[k]:cigar_off[k] + cigar_len[k]] (ASCII bytes) and
    mismatches[k] mismatches."""
    located: np.ndarray
    score: np.ndarray
    ref_begin: np.ndarray
    ref_end: np.ndarray
    query_begin: np.ndarray
    query_end: np.ndarray
    cigar: np.ndarray
    cigar_off: np.ndarray
    cigar_len: np.ndarray
    mismatches: np.ndarray


def _align_round(reads, read_off, refs, ref_off, devices,
                 nthreads) -> Aligned:
    """ssw_align over the pairs of flat int8 code buffers (pair k is
    reads[read_off[k]:read_off[k + 1]] against refs[ref_off[k]:...], int64
    offsets [n + 1]): one H2D of the buffers, the forward passes, the
    reverse pairs, the terminate passes, and one C traceback of the
    located pairs on nthreads threads (None: every core)."""
    p = align_kernels.pack_flat(reads, read_off, refs, ref_off,
                                device=devices[0])
    live = np.flatnonzero((p.rlen > 0) & (p.clen > 0))
    fwd = _forward(align_kernels.take(p, live), devices)
    hit = fwd[1] >= 0
    located, fwd = live[hit], fwd[:, hit]
    rev = _forward(_reverse_pairs(p, located, fwd), devices)
    score, end_ref, end_read = fwd[0], fwd[1], fwd[2]
    ref_begin, query_begin = end_ref - rev[3], end_read - rev[2]
    tb = traceback_flat(reads, read_off[located], p.rlen[located], refs,
                        ref_off[located], p.clen[located], score, ref_begin,
                        end_ref, query_begin, end_read, nthreads)
    return Aligned(located, score, ref_begin, end_ref, query_begin,
                   end_read, *tb)


def first_items(seeds: np.ndarray):
    """The first round's pending items of a seed stream (int64 [N, 4]:
    start, end, motif length, rank): the seeds of rank other than -1 that
    span 0.9 of their motif.  Returns (their seed indices, (start, end,
    motif length, seed type))."""
    s, e, m, rank = np.asarray(seeds, np.int64).reshape(-1, 4).T
    first = np.flatnonzero((rank != -1) & ((e - s) >= 0.9 * m))
    return first, (s[first], e[first], m[first], rank[first])


def _order(keys: List[np.ndarray]) -> np.ndarray:
    """The sequential path's order of every round's lines from their key
    rows (the item's path, then the candidate or -1): lexicographic, a
    shorter row padded with -1, so that a large-motif item's line comes
    before its children's and their subtrees keep the recursion's
    depth-first order."""
    width = max(k.shape[1] for k in keys)
    rows = np.vstack([np.pad(k, ((0, 0), (0, width - k.shape[1])),
                             constant_values=-1) for k in keys])
    return np.lexsort(rows.T[::-1])


def refine_batched(seeds: np.ndarray, sequence: str, sequence_id: str,
                   code: np.ndarray, n_mask: np.ndarray, sess,
                   cfg: RibbitConfig, device="cuda") -> List[str]:
    """Refine the merged seed stream with batched alignment rounds.

    sess: the contig's CoreSession, whose round entries build each round's
    requests and emit its lines on the session's threads.  The forward
    passes run on `device`, or split over a list of devices (_forward).
    Returns BED lines in the sequential path's exact order.  Raises,
    before any pass, if the C traceback library does not build: there is
    no fallback."""
    get_traceback_lib()
    devices = make_mesh(devices=device if isinstance(device, (list, tuple))
                        else [device])
    translated = _translate_codes(sequence)
    nthreads = sess.nthreads
    first, items = first_items(seeds)
    path = first[:, None]            # an item's key: its recursion path
    lines: List[str] = []
    keys: List[np.ndarray] = []
    while items[0].size:
        start, end, mlen, seed_type = items
        req = sess.round_requests(translated, start, end, mlen,
                                  mlen - cfg.min_shift, nthreads=nthreads)
        al = _align_round(req.reads, req.read_off, req.refs, req.ref_off,
                          devices, nthreads)
        cigar_off = np.zeros(req.n, np.int64)
        cigar_len = np.zeros(req.n, np.int64)
        cigar_off[al.located] = al.cigar_off
        cigar_len[al.located] = al.cigar_len
        em = sess.round_emit(req, sequence_id, start, end, mlen, seed_type,
                             al.cigar, cigar_off, cigar_len, nthreads)
        lines += em.lines
        src = req.item[em.line_req]
        keys.append(np.column_stack([path[src], req.cand[em.line_req]]))
        parent = req.item[em.p_req]
        path = np.column_stack([path[parent], em.p_child])
        items = (em.p_start, em.p_end, mlen[parent], seed_type[parent])
    if not lines:
        return []
    return [lines[i] for i in _order(keys)]
