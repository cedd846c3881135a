"""The plain reference of ribbit: BED lines of one sequence, in numpy and
Python alone.

  encode -> scan arrays (scan_host) -> scanner replays and lattices
  (events, lattice) -> three-pointer seed merge -> process_seed /
  process_seed_motifwise (refine; every alignment and the motif vote in
  numpy) -> BED lines

A frozen copy of the repository's Python engine, the semantic
specification of the upstream ribbit binary, with the two C calls it makes
replaced by their numpy specs.  It imports nothing of the program.  The
seeds are refined independently of each other, so `workers` > 1 refines
contiguous blocks of them in spawned processes (with the caller's
cigarproc.FLOAT) and concatenates the blocks in seed order: the same
lines in the same order.
"""

from __future__ import annotations

import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import cigarproc, scan_host
from .config import (RANK_A, RANK_N, RANK_P, RANK_S,
                     WINDOW_BITCOUNT_ANCHORED, WINDOW_BITCOUNT_SUBSTITUTION,
                     RibbitConfig)
from .encode import encode
from .events import run_anchored_scan, run_perfect_scan, run_substitution_scan
from .refine import (longest_continuous_matches, process_seed,
                     process_seed_motifwise)

RECURSION_LIMIT = 1_000_000
BLOCK = 64          # seeds per task of the refinement pool


def _allow_deep_recursion() -> None:
    """The lattices and processSeed recurse in proportion to local seed
    structure."""
    if sys.getrecursionlimit() < RECURSION_LIMIT:
        sys.setrecursionlimit(RECURSION_LIMIT)


class _BitmapCounter:
    """bitcount(midx, start, end) over a bool [NSHIFTS, L] matrix."""

    def __init__(self, bitmaps: np.ndarray):
        self.bitmaps = bitmaps

    def __call__(self, midx: int, start: int, end: int) -> int:
        if start < 0:
            start = 0
        return int(np.count_nonzero(self.bitmaps[midx, start:end]))


def _merged(perfect, substut, anchored):
    """The final 3-pointer merge by seed start; P wins ties over S over A
    (fasta_utils.cpp:181-242)."""
    pi = si = ai = 0
    smallest_type = -1
    while pi < len(perfect) or si < len(substut) or ai < len(anchored):
        smallest = (1 << 64) - 1
        if pi < len(perfect) and smallest > perfect[pi][0]:
            smallest = perfect[pi][0]
            smallest_type = RANK_P
        if si < len(substut) and smallest > substut[si][0]:
            smallest = substut[si][0]
            smallest_type = RANK_S
        if ai < len(anchored) and smallest > anchored[ai][0]:
            smallest = anchored[ai][0]
            smallest_type = RANK_A
        if smallest_type == RANK_P:
            seed = perfect[pi]
            pi += 1
        elif smallest_type == RANK_S:
            seed = substut[si]
            si += 1
        else:
            seed = anchored[ai]
            ai += 1
        yield seed


def seeds_of(code: np.ndarray, n_mask: np.ndarray, cfg: RibbitConfig):
    """(merged seeds, overlay): the seed list (start, end, mlen, rank) of
    one sequence and the anchored overlay its refinement reads."""
    _allow_deep_recursion()
    eq = scan_host.match_bitmaps(code, cfg)
    anchors = scan_host.anchor_bitmaps(eq, cfg)
    overlay = scan_host.overlay_bitmaps(eq, anchors, cfg)
    del anchors
    qual7 = scan_host.window_qualified(eq, n_mask,
                                       WINDOW_BITCOUNT_SUBSTITUTION)
    qual6 = scan_host.window_qualified(overlay, n_mask,
                                       WINDOW_BITCOUNT_ANCHORED)
    raw_bitcount = _BitmapCounter(eq)
    perfect = run_perfect_scan(eq, n_mask, raw_bitcount, cfg)
    substut = run_substitution_scan(qual7, n_mask, raw_bitcount, perfect, cfg)
    del qual7
    anchored = run_anchored_scan(qual6, n_mask, _BitmapCounter(overlay),
                                 perfect, substut, cfg)
    return [tuple(s) for s in _merged(perfect, substut, anchored)], overlay


def refine_seeds(seeds, sequence_id: str, sequence: str, code: np.ndarray,
                 n_mask: np.ndarray, overlay: np.ndarray,
                 cfg: RibbitConfig) -> list:
    """BED lines of a list of seeds, in seed order (fasta_utils.cpp:224-240)."""
    _allow_deep_recursion()
    L = len(sequence)
    out: list = []

    def clr_of(midx: int):
        ch = overlay[midx]
        return lambda a, b: longest_continuous_matches(ch[a:b])

    for seed_start, seed_end, seed_mlen, seed_type in seeds:
        if seed_type == RANK_N:
            continue
        if seed_end - seed_start >= 0.9 * seed_mlen:
            clr = clr_of(cfg.motif_channel(seed_mlen))
            if seed_mlen <= 10:
                process_seed_motifwise(seed_start, seed_end, seed_mlen,
                                       seed_type, sequence_id, sequence, L,
                                       clr, code, n_mask, cfg, out.append)
            else:
                process_seed(seed_start, seed_end, seed_mlen, seed_type,
                             sequence_id, sequence, L, clr, code, n_mask,
                             cfg, out.append)
    return out


_WORKER: dict = {}


def _worker_init(sequence_id, sequence, overlay, cfg, purity_float) -> None:
    cigarproc.FLOAT = purity_float      # the caller's precision, as set
    code, n_mask = encode(sequence)
    _WORKER.update(sid=sequence_id, seq=sequence, code=code, n_mask=n_mask,
                   overlay=overlay, cfg=cfg)


def _worker_block(seeds) -> list:
    w = _WORKER
    return refine_seeds(seeds, w["sid"], w["seq"], w["code"], w["n_mask"],
                        w["overlay"], w["cfg"])


def process_sequence(sequence_id: str, sequence: str, cfg: RibbitConfig,
                     workers: int = 1) -> list:
    """BED lines of one sequence (11 tab-separated columns), in the upstream
    binary's order."""
    if not sequence:
        return []
    code, n_mask = encode(sequence)
    seeds, overlay = seeds_of(code, n_mask, cfg)
    if workers <= 1 or len(seeds) <= BLOCK:
        return refine_seeds(seeds, sequence_id, sequence, code, n_mask,
                            overlay, cfg)
    blocks = [seeds[i:i + BLOCK] for i in range(0, len(seeds), BLOCK)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx,
                             initializer=_worker_init,
                             initargs=(sequence_id, sequence, overlay,
                                       cfg, cigarproc.FLOAT)) as pool:
        parts = list(pool.map(_worker_block, blocks))
    return [line for part in parts for line in part]
