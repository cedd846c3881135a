#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ribbit_tpu_torch) on one GPU.

    python3 chip_smoke.py               # every phase, one card

Phases, each of which raises on failure (exit code 1, no result line):
  1. the card (nvidia-smi name and power limit), torch, CUDA and nvcc;
  2. build of the CUDA kernels from ribbit_tpu_torch/csrc (one nvcc per
     source, all at once), of the C core from csrc/ and of the batched
     route's traceback (ribbit_tpu_torch/csrc/traceback.c);
  3. the event kernels against their plain PyTorch versions on the card,
     bit-equal, on one full 8 Mi-bp segment plus halo of a simulated
     chromosome, on edge lengths (the event kernel's tile edges among
     them), a poly-A case with N at word edges, an all-N one and planted
     eq runs at the anchor limits (anchor_edge_plan) and at the perfect-run
     cutoffs (perfect_edge_plan), at three motif configurations (the
     default, -m 4 -M 37 and -M 300); times of both at the segment shape
     (CUDA events, after a warm-up), their share of the bound and their
     rate in GB/s, and the anchor kernel's time at each configuration;
  4. the event-extraction path end to end through the port's CLI
     (--backend gpu) on a ~47 Mb five-contig genome made with the port's
     sim: launch counts, event streams against the C generation
     (capture_runs_host), BED against the port's host route byte for byte,
     and wall times;
  5. the SSW kernels against their plain version on the card, bit-equal on
     all four outputs in forward and terminate mode: every round-1 pair of
     refine_batched on a 1,031,571 bp contig and its reverse pair, and edge
     pairs (length 1, both sides of fits(), all N, the largest pair, reads
     of 8 and 31-33, 63-65 rows against refs of 20 and 700, a column max
     tied across two strips, terminate hits at column 0, the last column
     and never, a 17,000 bp perfect match whose score clamps at 32767,
     reads one row past a band and of 29,999 rows); times at the round-1
     batch (with the wrapper's host plan and its launches alone), and of
     the launches alone without its largest 1% of pairs and on its
     largest pair;
  6. device-batched refinement end to end (refine_batched, the JAX
     package's single-contig device route: the C round entries, the SSW
     kernels, the C traceback): the port's CLI on that contig
     (--backend gpu with RIBBIT_BATCHED_REFINE=1) against the host route;
     process_sequence (extraction, replay and refinement) without and
     with the variable, the C pool against the route, in 2 rounds of
     A B B A; refine_batched and the C pool in C R R C over one replayed
     session of it, every BED against the host route's; on chr21, refine_batched over phase 4's replayed session
     against the host route's chr21 lines, beside phase 4's C-pool
     refinement; each route run's launch counts (counted from 0 just
     before it), each round's pairs and cells, and each
     route run's wall time split into request building, H2D, forward
     passes, the reverse build, terminate passes, the C batch traceback
     (raises above 1 s on the contig), emission and the final order;
     then the C traceback against the Python spec (align.banded_sw +
     _mark_mismatch) on at most 1,000 of phase 5's round-1 pairs, the 10
     largest among them, located by the SSW kernels, with its time on 1
     thread and on every core;
  7. the dense-mask kernel against its plain version on the card,
     bit-equal on all four planes, and its q7, q6 and pm rows against the
     event words' bits, on phase 3's inputs (the planted perfect runs,
     perfect_edge_plan, among them) at its three configurations; its time,
     share of the bound and GB/s at the segment shape at each;
  8. the dense path end to end: scan_events_via_masks segment by segment
     with exact stitching on the five-contig genome, chr21's streams
     against the event path's, replay and refinement in the C core, BED
     against phase 4's byte for byte, launch count and wall time;
  9. the int32 probe against its plain version, bit-equal at three depths
     (the full one, one loop body, two), its SASS loop count by opcode and
     a source operation (raises below one instruction an operation) and
     counted rate (raises above 105% of the spec int32 rate), the SM clock
     nvidia-smi samples over 1.5 s of its reps, then
     bench_device.run_device_bench() and its JSON line;
 10. the eq_sum8 kernel against its plain version on the card, bit-equal
     on both outputs, on phase 3's inputs at both configurations and on
     the edge lengths at -M 300 (past the Pallas kernel's row cap); its
     time at the segment shape;
 11. the Python engine end to end on phase 5's contig: the dense scan
     (scan_dense.scan_arrays) on the card against the numpy spec
     (scan_host), all five arrays; process_sequence(engine="python")
     against the port's host route (the C core), BED byte for byte;
     launch counts and the wall time split into the device scan, the
     scanners and lattices, and refinement;
 12. the parallel routes (ribbit_tpu_torch.parallel), whose device lists
     repeat the one card: distributed_process_contig on chr21's first 16
     Mi-bp at 4 Mi-bp chunks over [cuda:0, cuda:0] (BED against the host
     route's on that prefix, K1 and K2 launches against the chunk count,
     the wall time split into extraction, stitching, replay and
     refinement) and over the default device list on phase 5's contig at
     256 Ki-bp chunks; the sharded scan
     on four 2 Mi-bp chunks of chr21 with N runs (eq and counts against
     eq_sum8_ref and the window rule, exact K10 launches); the split SSW
     forward on phase 5's round-1 fits() pairs and their terminate pairs,
     bit-equal to one device; refine_batched_sharded on a 53,543 bp
     contig against the host route (K3 and K4 launched); two CLI
     processes in one gloo group (--coordinator) on phase 5's contig,
     rank 0's BED against the host route's;
 13. the device-batched voter (vote_device, on no route) against the C
     voter (ribbit_vote_longer): the call sets of the host route on phase
     5's contig and on chr21 (RIBBIT_VOTE_DUMP); every winner of the
     first through impl="banded" and of its buckets up to ssl 1024 through
     impl="spec"; a sample of at most 4 batches per ssl bucket of chr21's;
     planted tandem repeats of m = 150, 200 and 300 (a perfect one) through
     both; per-bucket wall times, CUDA-event device spans and walk steps
     against the C voter on one thread and on 8 in the same run.
Before the kernels line comes {"voter": {...}} (phase 13).  The line
before the last is {"kernels": [...]} (launches: phases 4, 6's CLI
run, 8, 9 and 11; refine_launches, K3 and K4 only: phase 6's other
route runs, each counted on its own; parallel_launches: phase 12); the
last line is {"ok": true,
"device": {...}}.  Imports nothing of jax or ribbit_tpu.

`python3 chip_smoke.py --route-abba N` runs the build and then phase 6's
A B B A of process_sequence alone, N rounds (the single-contig route
choice's measure, at more rounds than the whole script can afford).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ribbit_tpu_torch import bench_roofline as br
from ribbit_tpu_torch.bench_roofline import bound, cuda_ms

CHR21_BP = 46_709_983          # hg38 chr21
BP_PER_LOCUS = 2660            # bench.py's chromosome recipe
# lengths at word edges, at the edges of a warp's 32 words in the event
# kernel and at one and two of its tiles (256 words), +-1
EDGE_LENGTHS = (1, 7, 8, 101, 102, 103, 1023, 1024, 1025, 4097, 8191, 8192,
                8193, 16383, 16384, 16385)
POLY_A_BP = 12_000             # across the event kernel's first tile edge
# shifts of the planted anchor runs, and the anchor kernel's tile (512
# words of 32 positions)
ANCHOR_UNITS = (2, 3, 16, 17, 50, 102)
ANCHOR_TILE = 512 * 32
# shifts of the planted perfect runs (the cutoff rule changes between 6
# and 7, the dense kernel's run walk starts at 33), and the dense kernel's
# tile (256 words of 32 positions) where L % 16 == 0
PERFECT_UNITS = (2, 3, 6, 7, 31, 32, 33, 34, 64, 100, 200, 300)
DENSE_TILE = 256 * 32
KERNEL_REPS = 20
PLAIN_REPS = 3
SSW_REPS = 5
TRACEBACK_SAMPLE = 1000        # phase 6: round-1 pairs held against the spec
TRACEBACK_MAX_S = 1.0          # phase 6: the C traceback's whole route
ROUTE_ABBA = 2                 # phase 6: A B B A rounds of process_sequence
# the batched route's contig: 1,031,571 bp, about one yeast chromosome
ROUTE_LOCI, ROUTE_SEED = 400, 38
CLAMP_BP = 17_000              # 2 x 17,000 passes 32,767: diag clamps
BAND_EDGE = 8193               # one row past a band of the large kernel
LONG_READ = 29_999             # four bands, the last of 5,423 rows
SOURCES = ("scan_events", "ssw_forward", "alu_probe", "scan_dense")
CLOCK_WINDOW_MS = 1500         # the probe's reps while nvidia-smi samples
# -M past the Pallas eq/sum8 kernel's cap; the event kernel's shifts then
# reach ten words ahead
BIG_M = 300
# phase 12: chr21's prefix through distributed_process_contig and its
# chunks (4, over a device list of 2); chunks of the route contig on the
# default device list and in the two multi-host processes (4 chunks of
# 1.03 Mb); the sharded scan's chunks of chr21; the split refinement's
# contig (53,543 bp, 1,170 round-1 pairs, 25 of them past fits()); the
# processes' time limit
PAR_CHR21_BP, PAR_CHUNK = 16 << 20, 4 << 20
ROUTE_CHUNK = 262_144
SCAN_CHUNK, SCAN_CHUNKS = 2 << 20, 4
REFINE_LOCI = 20
MULTIHOST_TIMEOUT = 300
# phase 13: chr21's sample (batches per ssl bucket), the largest ssl
# bucket of the route set that the spec walk runs too, the planted motifs
# (up to -M 300) and the C voter's thread pool
VOTE_SAMPLE_BATCHES = 4
VOTE_SPEC_MAX_SSL = 1024
VOTE_PLANTED_M = (150, 200, 300)
VOTE_THREADS = 8


def log(*a):
    print(*a, flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    wide = torch.int64 if a.element_size() >= 4 else torch.int32
    return int((a.to(wide) - b.to(wide)).abs().max())


def write_fasta(path: str, contigs) -> int:
    total = 0
    with open(path, "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + "\n")
            total += len(seq)
    return total


def phase_build():
    """Every kernel source and the C core, built at once; loads them."""
    from ribbit_tpu_torch import cuda_build
    from ribbit_tpu_torch.core import get_core_lib
    from ribbit_tpu_torch.native import get_traceback_lib

    def timed(fn, *a):
        t = time.perf_counter()
        fn(*a)
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(SOURCES) + 2) as ex:
        futs = {f"ribbit_tpu_torch/csrc/{stem}.cu": ex.submit(
            timed, cuda_build.build, stem) for stem in SOURCES}
        futs["the C core (csrc/*.c)"] = ex.submit(timed, get_core_lib)
        futs["ribbit_tpu_torch/csrc/traceback.c"] = ex.submit(
            timed, get_traceback_lib)
        for name, f in futs.items():
            log(f"    built {name} in {f.result():.1f} s")
    for stem in SOURCES:
        cuda_build.load(stem)


def poly_a_n(L: int = POLY_A_BP, seed: int = 0) -> str:
    """Random stretches between poly-A runs of 1-140 bp (5% substitutions),
    with N at the last and the first position of words 4m and one N at
    offset m % 32 of word 4m + 2: the 8-windows of eq hold every count
    from 0 to 8, and N-free windows begin and end at every offset of a
    word (tests/test_torch_scan_events.py checks both)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, L)
    p = 0
    while p < L:
        p += int(rng.integers(0, 48))
        run = codes[p:p + int(rng.integers(1, 141))]
        run[:] = np.where(rng.random(len(run)) < 0.05,
                          rng.integers(1, 4, len(run)), 0)
        p += len(run)
    bases = np.frombuffer(b"ACGT", np.uint8)[codes]
    words = np.arange(L // 32)
    bases[32 * words[1::4] - 1] = ord("N")
    bases[32 * words[0::4]] = ord("N")
    bases[32 * words[2::4] + np.arange(len(words[2::4])) % 32] = ord("N")
    return bases.tobytes().decode()


def anchor_run_lengths(m: int):
    """Lengths of the eq runs planted on shift m: too short, the shortest
    and the longest anchor, and the first two that are too long."""
    return tuple(dict.fromkeys((2, 3, 2 * m - 1, 2 * m, 2 * m + 1)))


def _plant(codes, rng, a: int, m: int, k: int, unit=None):
    """A perfect tandem repeat of a unit of m bases (random unless given)
    over positions [a, a + m + k) (cut at the end of codes, which reads as
    0 past it), with the bases around it chosen so that eq of shift m
    holds exactly the run [a, a + k).  Returns (m, a, k)."""
    L = len(codes)
    unit = rng.integers(0, 4, m) if unit is None else unit
    if a + m + k > L:                     # the run's last compare reads 0
        unit[(L - a) % m] = 0
    end = min(a + m + k, L)
    codes[a:end] = unit[np.arange(end - a) % m]
    if a > 0:                             # eq[a - 1] = 0
        codes[a - 1] = (unit[(m - 1) % m] + 1) % 4
    if a + m + k < L:                     # eq[a + k] = 0
        codes[a + m + k] = (unit[k % m] + 1) % 4
    return m, a, k


def anchor_edge_plan(seed: int = 0):
    """(name, sequence, runs): eq runs of exactly k on shift m (runs as
    (m, start, k)) for m in ANCHOR_UNITS and k in anchor_run_lengths(m).
    One sequence straddles with every (m, k) a tile edge of the anchor
    kernel (16,384 positions), an edge of a 64-word tile (2,048) and a word
    edge; one short sequence per (m, k) starts with a run of k at p = 0
    and ends with a run of 2m - 1 (the first three) or 3 whose exclusive
    end is L - m - 1, L - m and L - m + 1 in turn."""
    rng = np.random.default_rng(seed)
    pairs = [(m, k) for m in ANCHOR_UNITS for k in anchor_run_lengths(m)]
    codes = rng.integers(0, 4, ANCHOR_TILE * (len(pairs) + 1) + 512)
    runs = []
    for j, (m, k) in enumerate(pairs):
        base = ANCHOR_TILE * (j + 1)
        for edge in (base, base + 2048, base + 5120):
            runs.append(_plant(codes, rng, edge - k // 2, m, k))
    plan = [("anchor edges", codes, runs)]
    for m in ANCHOR_UNITS:
        for c, k in enumerate(anchor_run_lengths(m)):
            L = 8 * m + 256
            codes = rng.integers(0, 4, L)
            tail = 2 * m - 1 if c < 3 else 3
            end = L - m - 1 + c % 3
            plan.append((f"anchor ends m={m} k0={k}", codes,
                         [_plant(codes, rng, 0, m, k),
                          _plant(codes, rng, end - tail, m, tail)]))
    return [(name, np.frombuffer(b"ACGT", np.uint8)[codes].tobytes()
             .decode(), runs) for name, codes, runs in plan]


def cutoff(m: int) -> int:
    """The shortest perfect run on shift m (parse_perfect_shiftxor.cpp)."""
    return 12 - m if m <= 6 else m


def perfect_edge_plan(seed: int = 0):
    """(name, sequence, runs): eq runs of exactly k on shift m (runs as
    (m, start, k)) for m in PERFECT_UNITS and k in cutoff(m) - 1, cutoff(m)
    and cutoff(m) + 1.  One sequence (a multiple of 32 long) puts every
    (m, k) across a tile edge of the dense kernel (DENSE_TILE), across a
    word edge, and from the last bit of a word.  One short sequence per
    (m, k) starts with a run of k at p = 0, holds a run of cutoff(m) + 1
    cut by one N at offset cutoff(m) - 1 (the unit has an A there, so the
    code is unchanged and eq keeps the run), and ends with k A's: an eq run
    of exactly k on every shift whose last position is L - 1 (the base
    before it is not A).  The short lengths take every residue mod 16."""
    rng = np.random.default_rng(seed)
    pairs = [(m, k) for m in PERFECT_UNITS
             for k in (cutoff(m) - 1, cutoff(m), cutoff(m) + 1)]
    codes = rng.integers(0, 4, DENSE_TILE * (len(pairs) + 1) + 512)
    runs = []
    for j, (m, k) in enumerate(pairs):
        base = DENSE_TILE * (j + 1)
        for a in (base - k // 2, base + 4096 - k // 2, base + 2048 + 31):
            runs.append(_plant(codes, rng, a, m, k))
    plan = [("perfect edges", codes, runs, [])]
    for i, (m, k) in enumerate(pairs):
        c = cutoff(m)
        a = m + k + 16                       # the run cut by N
        L = a + m + c + 19 + k
        L += (i - L) % 16
        codes = rng.integers(0, 4, L)
        unit = rng.integers(0, 4, m)
        unit[(c - 1) % m] = 0
        runs = [_plant(codes, rng, 0, m, k),
                _plant(codes, rng, a, m, c + 1, unit)]
        codes[L - k:] = 0
        codes[L - k - 1] = rng.integers(1, 4)
        runs.append((m, L - k, k))
        plan.append((f"perfect ends m={m} k={k}", codes, runs, [a + c - 1]))
    out = []
    for name, codes, runs, ns in plan:
        bases = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
        bases[ns] = ord("N")
        out.append((name, bases.tobytes().decode(), runs))
    return out


def kernel_cases(genome_seq: str):
    """(name, sequence): one full segment plus halo of the chromosome,
    random sequences at the edge lengths (10% N), the poly-A case, an
    all-N one, the planted anchor runs (anchor_edge_plan) and perfect runs
    (perfect_edge_plan)."""
    from ribbit_tpu_torch.eventstitch import HALO

    seg_len = (8 << 20) + 2 * HALO
    rng = np.random.default_rng(0)
    cases = [("segment", genome_seq[:seg_len])]
    for L in EDGE_LENGTHS:
        codes = rng.integers(0, 4, L)
        bases = np.frombuffer(b"ACGT", np.uint8)[codes]
        bases[rng.random(L) < 0.1] = ord("N")
        cases.append(("random", bases.tobytes().decode()))
    cases.append(("poly-A/N", poly_a_n()))
    cases.append(("all-N", "N" * 5000))
    cases += [(name, seq) for name, seq, _ in anchor_edge_plan()]
    cases += [(name, seq) for name, seq, _ in perfect_edge_plan()]
    return cases


def phase_kernels(se, cases, cfgs, dev, rate):
    """Kernel vs plain version, bit-equal; times and bounds at the segment
    shape."""
    from ribbit_tpu_torch.encode import encode

    err = {"anchor_planes": 0, "event_words": 0, "overlay": 0}
    times, k1_ms = {}, {}
    for cfg in cfgs:
        tag = f"m{cfg.min_motif}-M{cfg.max_motif}"
        for name, seq in cases:
            code, n_mask = encode(seq)
            c = torch.from_numpy(code.view(np.uint8)).to(dev)
            n = torch.from_numpy(n_mask.view(np.uint8)).to(dev)
            a_k = se.anchor_planes(c, cfg)
            a_p = se.anchor_planes_ref(c, cfg)
            e_a = max_abs_err(a_k, a_p)
            # the event pass as the pipeline runs it: with the packed
            # overlay (poisoned first, so a word left unwritten shows)
            ov_k = torch.full((cfg.nmotifs, se.overlay_row_words(len(seq))),
                              -1, dtype=torch.int32, device=dev)
            w_k = se.event_words(c, n, a_k, cfg, overlay=ov_k)
            w_p = se.flagwords_ref(c, n, a_p, cfg)
            e_w = max_abs_err(w_k, w_p)
            e_o = int((ov_k != se.overlay_words_ref(c, a_p, cfg)).sum())
            torch.cuda.synchronize()
            log(f"  {tag} {name} L={len(seq)}: anchor_planes err {e_a}, "
                f"event_words err {e_w}, overlay words differing {e_o}")
            err["anchor_planes"] = max(err["anchor_planes"], e_a)
            err["event_words"] = max(err["event_words"], e_w)
            err["overlay"] = max(err["overlay"], e_o)
            if e_a or e_w or e_o:
                raise AssertionError(f"kernel != plain version ({tag} "
                                     f"{name}: {e_a}, {e_w}, {e_o})")
            if name == "segment":
                # the anchor kernel's halo grows with the largest shift
                k1_ms[tag] = cuda_ms(lambda: se.anchor_planes(c, cfg),
                                     KERNEL_REPS)
            if name == "segment" and cfg is cfgs[0]:
                L = len(seq)
                times["anchor_planes"] = (
                    k1_ms[tag],
                    cuda_ms(lambda: se.anchor_planes_ref(c, cfg),
                            PLAIN_REPS))
                times["event_words"] = (
                    cuda_ms(lambda: se.event_words(c, n, a_k, cfg,
                                                   overlay=ov_k),
                            KERNEL_REPS),
                    cuda_ms(lambda: se.flagwords_ref(c, n, a_k, cfg),
                            PLAIN_REPS))
                for k in times:
                    work = br.scan_work(k, L, cfg)
                    times[k] += bound(*work, rate) + (work[0],)
                # the rest of one segment's extraction, on the host clock
                # (second of two runs: the first pays page faults)
                for _ in range(2):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    w_host = w_k.cpu().numpy()
                    d2h = time.perf_counter() - t
                    t = time.perf_counter()
                    se._decode_c(w_host, cfg)
                    dec = time.perf_counter() - t
                log(f"  segment L={len(seq)}: words {w_host.nbytes / 1e6:.1f}"
                    f" MB, D2H {d2h * 1e3:.1f} ms "
                    f"({w_host.nbytes / d2h / 1e9:.2f} GB/s), C decode "
                    f"{dec * 1e3:.1f} ms")
            del a_k, a_p, w_k, w_p, ov_k
    for k, (ms, pms, bms, by, nbytes) in times.items():
        log(f"  {k} at the segment shape: kernel {ms:.4f} ms, plain "
            f"{pms:.3f} ms ({pms / ms:.1f}x), bound {bms:.4f} ms by {by} "
            f"({bms / ms:.1%} of it), {nbytes / ms / 1e6:.1f} GB/s")
    log("  anchor_planes at the segment shape by configuration: "
        + ", ".join(f"{tag} {ms:.4f} ms" for tag, ms in k1_ms.items()))
    return err, times


def phase_e2e(se, genome, cfg, dev):
    """The port's CLI with --backend gpu against the C generation and the
    port's host route."""
    from ribbit_tpu_torch.cli import main as cli_main
    from ribbit_tpu_torch.core import CoreSession
    from ribbit_tpu_torch.encode import encode
    from ribbit_tpu_torch.eventstitch import (capture_runs_host,
                                              scan_events_segmented,
                                              segment_bounds)
    from ribbit_tpu_torch.host import process_fasta as host_process_fasta
    from ribbit_tpu_torch.pipeline import SEG_SIZE

    with tempfile.TemporaryDirectory(prefix="ribbit_smoke_") as tmp:
        fa = os.path.join(tmp, "genome.fa")
        bed = os.path.join(tmp, "port.bed")
        total = write_fasta(fa, genome)
        mb = total / 1e6
        nseg = sum(len(segment_bounds(len(s), SEG_SIZE)) - 1
                   for _, s in genome)
        log(f"  genome: {len(genome)} contigs, {total} bp, {nseg} device "
            "segments")

        se.anchor_planes.launches = 0
        se.event_words.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        rc = cli_main(["--backend", "gpu", "--device", str(dev), "-i", fa,
                       "-o", bed])
        torch.cuda.synchronize()
        port_s = time.perf_counter() - t
        launches = {"anchor_planes": se.anchor_planes.launches,
                    "event_words": se.event_words.launches}
        peak = torch.cuda.max_memory_allocated(dev)
        if rc != 0:
            raise AssertionError(f"port CLI exited {rc}")
        log(f"  launches in the CLI run: {launches}; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched: {launches}")
        if launches["event_words"] != nseg:
            raise AssertionError(f"event_words ran {launches['event_words']}"
                                 f" times for {nseg} segments")
        with open(bed) as fh:
            port_lines = fh.read().splitlines()

        t = time.perf_counter()
        host_lines = host_process_fasta(fa, cfg)
        host_s = time.perf_counter() - t
        same_bed(port_lines, host_lines, "the port's host route")

    kept = None
    for name, seq in genome:
        code, n_mask = encode(seq)
        seg_s = []

        def timed_extractor(c, n, cfg_):
            t0 = time.perf_counter()
            res = se.scan_events_device(c, n, cfg_, dev)
            seg_s.append(time.perf_counter() - t0)
            return res

        # extract_events with each segment's extraction timed apart from
        # the stitching
        t = time.perf_counter()
        got = scan_events_segmented(code, n_mask, cfg,
                                    extractor=timed_extractor,
                                    seg_size=SEG_SIZE)
        ext_s = time.perf_counter() - t
        t = time.perf_counter()
        want = capture_runs_host(code, n_mask, cfg)
        cap_s = time.perf_counter() - t
        faults = check_events(got, want, code, n_mask, cfg, name)
        sess = CoreSession(code, n_mask, cfg, nthreads=os.cpu_count() or 1)
        try:
            t = time.perf_counter()
            sess.set_events(*got)
            seeds = sess.scan()
            scan_s = time.perf_counter() - t
            sess.refine(seeds, seq, name)
            refine_s = time.perf_counter() - t - scan_s
        except BaseException:
            sess.close()
            raise
        if name == "chr21":         # phase 6 runs the batched route on it
            kept = (sess, seeds, refine_s)
        else:
            sess.close()
        but = (f" but for {faults} run(s) where the port equals the numpy "
               "spec" if faults else "")
        log(f"  {name} ({len(seq)} bp): {sum(len(g[0]) for g in got)} "
            f"events equal capture_runs_host{but}; "
            f"port extraction {ext_s:.2f} s ({len(seg_s)} segment(s) "
            f"{sum(seg_s):.2f} s, stitching {ext_s - sum(seg_s):.2f} s), "
            f"C replay {scan_s:.2f} s, "
            f"C refinement {refine_s:.2f} s ({len(seeds)} seeds); "
            f"C generation (capture) {cap_s:.2f} s")
    return launches, port_s, host_s, mb, port_lines, host_lines, kept


def same_bed(got, want, what: str):
    """Raise unless two BED line lists are identical, in order."""
    if got != want:
        diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    min(len(got), len(want)))
        raise AssertionError(f"BED differs from {what}: {len(got)} vs "
                             f"{len(want)} lines, first difference at line "
                             f"{diff}")
    log(f"  BED identical to {what}, in order: {len(got)} lines")


def spec_runs(code, n_mask, cfg, stream: int, ch: int):
    """(starts, ends) of one channel of one stream (0 perfect, 1 q7, 2 q6)
    by the numpy spec, the port's scan_host."""
    from types import SimpleNamespace

    from ribbit_tpu_torch import scan_host

    m = cfg.min_motif + ch
    lo = max(cfg.min_shift, m - 2)
    sub = SimpleNamespace(min_shift=lo, nshifts=min(cfg.max_shift, m + 2) - lo + 1)
    eq = scan_host.match_bitmaps(code, sub)
    row = eq[m - lo]
    if stream == 0:
        s, e = scan_host.perfect_runs(row, n_mask)
        keep = e - s >= (12 - m if m <= 6 else m)
        return s[keep], e[keep]
    if stream == 1:
        bits = row
    else:
        # overlay_bitmaps' neighbours of motif m: shifts m-2..m+2 but m
        anch = scan_host.anchor_bitmaps(eq, sub)
        bits = row.copy()
        for i in range(m - 2 if m > 2 else 1, m + 3):
            if i != m:
                bits |= anch[i - lo]
    q = scan_host.window_qualified(bits[None], n_mask, 7 if stream == 1
                                   else 6)[0] == 1
    return scan_host._runs(q)


def check_events(got, want, code, n_mask, cfg, name: str) -> int:
    """Port streams against capture_runs_host, channel by channel.  Where
    they differ, the numpy spec decides: the port must equal it.  Returns
    the number of runs by which capture_runs_host misses the spec."""
    faults = 0
    for k, sname in enumerate(("perfect", "q7", "q6")):
        (gs, ge, go), (ws, we, wo) = got[k], want[k]
        for ch in range(cfg.nmotifs):
            a = (gs[go[ch]:go[ch + 1]], ge[go[ch]:go[ch + 1]])
            b = (ws[wo[ch]:wo[ch + 1]], we[wo[ch]:wo[ch + 1]])
            if all(np.array_equal(x, y) for x, y in zip(a, b)):
                continue
            spec = spec_runs(code, n_mask, cfg, k, ch)
            if not all(np.array_equal(x, np.asarray(y, np.int64))
                       for x, y in zip(a, spec)):
                raise AssertionError(f"{name}: {sname} channel {ch} differs "
                                     "from capture_runs_host and the spec")
            extra = set(zip(*map(np.ndarray.tolist, a))) ^ set(
                zip(*map(np.ndarray.tolist, b)))
            faults += len(extra)
            log(f"  {name}: capture_runs_host misses the spec on {sname} "
                f"channel {ch} (motif {cfg.min_motif + ch}): "
                f"{sorted(extra)[:4]}; the port equals the spec")
    return faults


def round1_pairs(seq: str, cfg):
    """The live (read, ref) pairs of refine_batched's first alignment
    round on seq, in request order."""
    import ribbit_tpu_torch.refine_batched as rb
    from ribbit_tpu_torch.core import CoreSession
    from ribbit_tpu_torch.encode import encode

    code, n_mask = encode(seq)
    sess = CoreSession(code, n_mask, cfg, nthreads=os.cpu_count() or 1)
    try:
        _, (start, end, mlen, _) = rb.first_items(sess.scan())
        req = sess.round_requests(rb._translate_codes(seq), start, end,
                                  mlen, mlen - cfg.min_shift)
    finally:
        sess.close()
    pairs = [(req.reads[req.read_off[k]:req.read_off[k + 1]],
              req.refs[req.ref_off[k]:req.ref_off[k + 1]])
             for k in range(req.n)]
    return [(r, f) for r, f in pairs if r.shape[0] and f.shape[0]]


def reverse_pairs(reads, refs, fwd):
    """Terminate-mode pairs as refine_batched._reverse_pairs builds them
    from a forward result (int32 [4, n] on the host)."""
    keep = [i for i in range(len(reads)) if fwd[1, i] >= 0]
    return ([reads[i][:fwd[2, i] + 1][::-1].copy() for i in keep],
            [refs[i][:fwd[1, i] + 1][::-1].copy() for i in keep],
            [int(fwd[0, i]) for i in keep])


def needed_cells(p, out) -> int:
    """Cells a batch's passes need: every column of a forward pair, the
    columns up to the first hit of a terminate pair that has one."""
    out = out.cpu().numpy()
    term = p.term.cpu().numpy()
    cols = np.where((term >= 0) & (out[3] >= 0), out[3] + 1, p.clen)
    return int((p.rlen * cols).sum())


def check_ssw(kernel, reads, refs, terms, dev, what: str):
    """Kernel against the plain version on one batch; the kernel's output
    (int32 [4, n], host), the cells needed and the error (0)."""
    from ribbit_tpu_torch import align_kernels as ak
    p = ak.pack_pairs(reads, refs, terms, dev)
    k = kernel(p)
    w = ak.ssw_forward_ref(p)
    torch.cuda.synchronize()
    err = max_abs_err(k, w)
    cells = needed_cells(p, k)
    log(f"  {kernel.__name__} {what}: {p.n} pairs, {cells} cells, max "
        f"read {int(p.rlen.max())}, err {err}")
    if err:
        raise AssertionError(f"{kernel.__name__} != plain version ({what})")
    return k.cpu().numpy(), cells, err


def edge_pairs(largest):
    """(name, read, ref) pairs at the kernels' edges."""
    from ribbit_tpu_torch import align_kernels as ak
    rng = np.random.default_rng(0)

    def repeat(n, noise=0.05):
        unit = rng.integers(0, 4, int(rng.integers(2, 12))).astype(np.int8)
        a = np.resize(unit, n).copy()
        hit = rng.random(n) < noise
        a[hit] = rng.integers(0, 5, int(hit.sum()))
        return a, unit

    def ppr(unit, n):
        return np.resize(unit, n).astype(np.int8)

    out = [("length 1, match", np.int8([2]), np.int8([2])),
           ("length 1, mismatch", np.int8([2]), np.int8([1])),
           ("length 1, N", np.int8([4]), np.int8([4]))]
    for C in (160, 168):                 # 3 x 800 + C: 2560 fits, 2568 not
        r, u = repeat(800)
        out.append((f"3R+C={3 * 800 + C}", r, ppr(u, C)))
    out.append(("all N", np.full(50, 4, np.int8), np.full(60, 4, np.int8)))
    out.append(("largest round-1 pair", *largest))
    # strip edges of the wavefront: rows around multiples of a warp, short
    # (C < 32) and long refs
    for R in (8, 31, 32, 33, 63, 64, 65):
        for C in (20, 700):
            r, u = repeat(R)
            out.append((f"R={R} C={C}", r, ppr(u, C)))
    # one column max in two strips: the smaller row must win
    x = rng.integers(0, 4, 40).astype(np.int8)
    out.append(("column max tied across strips", np.concatenate([x, x]), x))
    perfect = rng.integers(0, 4, CLAMP_BP).astype(np.int8)
    out.append((f"{CLAMP_BP} bp perfect match", perfect, perfect.copy()))
    r, u = repeat(BAND_EDGE)
    out.append(("one row past a band", r, ppr(u, 100)))
    r, u = repeat(LONG_READ)
    out.append((f"{LONG_READ} bp read", r, ppr(u, 600)))
    return out


def terminate_edges():
    """(reads, refs, terms): hits at column 0 and at the last column, and a
    target never reached."""
    x = np.random.default_rng(1).integers(0, 4, 50).astype(np.int8)
    return ([np.int8([2, 1, 0]), x, x],
            [np.int8([2, 3, 3, 3]), x.copy(), x.copy()],
            [2, 2 * len(x), 999])


def time_split(name, entry, reads, refs, dev, rate):
    """The launches' time (align_kernels.prepare's launch(), the host plan
    made before) on a forward batch without its largest 1% of pairs (by
    cells) and on its largest pair alone: whether the batch's time is its
    largest pairs' walks."""
    from ribbit_tpu_torch import align_kernels as ak
    cells = np.array([r.shape[0] * f.shape[0] for r, f in zip(reads, refs)])
    by_size = np.argsort(-cells, kind="stable")
    cut = max(1, len(reads) // 100)
    for what, keep in ((f"without its largest {cut} pairs", by_size[cut:]),
                       ("largest pair alone", by_size[:1])):
        if not len(keep):
            continue
        p = ak.pack_pairs([reads[i] for i in keep], [refs[i] for i in keep],
                          None, dev)
        ms = cuda_ms(ak.prepare(p, *entry)[1], SSW_REPS)
        n = int(cells[keep].sum())
        bms, by = bound(p.read.numel() + p.ref.numel() + 16 * p.n,
                        n * br.SSW_OPS_PER_CELL, rate)
        log(f"  {name}, round 1 {what}: {p.n} pairs, {n} cells (largest "
            f"{int(cells[keep].max())}); the launches alone {ms:.3f} ms "
            f"({n / ms / 1e6:.2f} GCUPS), bound {bms:.4f} ms by {by}")


def phase_ssw(seq: str, cfg, dev, rate):
    """SSW kernels vs plain version, bit-equal; times and bounds at the
    round-1 batch."""
    from ribbit_tpu_torch import align_kernels as ak

    t = time.perf_counter()
    pairs = round1_pairs(seq, cfg)
    log(f"  round 1 of refine_batched on {len(seq)} bp: {len(pairs)} live "
        f"pairs ({time.perf_counter() - t:.1f} s on the host)")
    kernels = {"ssw_forward_small": ak.ssw_forward_small,
               "ssw_forward_large": ak.ssw_forward_large}
    entries = {"ssw_forward_small": (ak.SMALL_LANES,
                                     "ribbit_ssw_forward_small"),
               "ssw_forward_large": (ak.LARGE_LANES,
                                     "ribbit_ssw_forward_large")}
    classes = {"ssw_forward_small": [], "ssw_forward_large": []}
    for i, (r, f) in enumerate(pairs):
        small = ak.fits(r.shape[0], f.shape[0])
        classes["ssw_forward_small" if small else "ssw_forward_large"] \
            .append(i)
    stats = {}
    for name, kernel in kernels.items():
        reads = [pairs[i][0] for i in classes[name]]
        refs = [pairs[i][1] for i in classes[name]]
        fwd, cells, e_f = check_ssw(kernel, reads, refs, None, dev,
                                    "round 1, forward")
        _, _, e_r = check_ssw(kernel, *reverse_pairs(reads, refs, fwd), dev,
                              "round 1, reverse (terminate)")
        p = ak.pack_pairs(reads, refs, None, dev)
        ms = cuda_ms(lambda: kernel(p), SSW_REPS)
        plain_ms = cuda_ms(lambda: ak.ssw_forward_ref(p), 1)
        bms, by = bound(p.read.numel() + p.ref.numel() + 16 * p.n,
                        cells * br.SSW_OPS_PER_CELL, rate)
        stats[name] = dict(max_abs_err=max(e_f, e_r), ms=ms,
                           plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        # the launches alone: the plan, its order and scratch made before
        _, launch = ak.prepare(p, *entries[name])
        launch_ms = cuda_ms(launch, SSW_REPS)
        log(f"  {name} at the round-1 forward batch: {p.n} pairs, {cells} "
            f"cells (largest pair {int((p.rlen * p.clen).max())}); kernel "
            f"{ms:.3f} ms with the wrapper's host plan, {launch_ms:.3f} ms "
            f"the launches alone ({cells / ms / 1e6:.2f} / "
            f"{cells / launch_ms / 1e6:.2f} GCUPS), plain {plain_ms:.1f} ms, "
            f"bound {bms:.4f} ms by {by} ({cells / bms / 1e6:.1f} GCUPS)")
        time_split(name, entries[name], reads, refs, dev, rate)

    largest = max(pairs, key=lambda rf: rf[0].shape[0] * rf[1].shape[0])
    edges = edge_pairs(largest)
    for name, kernel in kernels.items():
        sel = [e for e in edges if name == "ssw_forward_large"
               or ak.fits(e[1].shape[0], e[2].shape[0])]
        reads, refs = [e[1] for e in sel], [e[2] for e in sel]
        fwd, _, e_f = check_ssw(kernel, reads, refs, None, dev,
                                "edge pairs, forward: "
                                + "; ".join(e[0] for e in sel))
        _, _, e_r = check_ssw(kernel, *reverse_pairs(reads, refs, fwd), dev,
                              "edge pairs, reverse (terminate)")
        reads, refs, terms = terminate_edges()
        hits, _, e_t = check_ssw(kernel, reads, refs, terms, dev,
                                 "terminate hits at column 0, the last "
                                 "column, never")
        if hits[3].tolist() != [0, len(refs[1]) - 1, -1]:
            raise AssertionError(f"first hits {hits[3].tolist()}")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e_f,
                                         e_r, e_t)
        clamp = [i for i, e in enumerate(sel) if e[0].endswith("match")
                 and e[1].shape[0] == CLAMP_BP]
        for i in clamp:
            if fwd[0, i] != ak.WORD_MAX:
                raise AssertionError(f"the {CLAMP_BP} bp match scored "
                                     f"{fwd[0, i]}, not the clamp")
            log(f"  {name}: the {CLAMP_BP} bp match scores {fwd[0, i]} "
                "(clamped)")
    return stats, pairs


def sample_pairs(pairs, n: int = TRACEBACK_SAMPLE):
    """At most n of the pairs: the 10 largest (read x ref) and an evenly
    spaced sample of the rest, in their order."""
    cells = np.array([r.shape[0] * f.shape[0] for r, f in pairs])
    largest = set(np.argsort(-cells, kind="stable")[:10].tolist())
    rest = [i for i in range(len(pairs)) if i not in largest]
    k = min(len(rest), n - len(largest))
    pick = np.linspace(0, len(rest) - 1, k).round().astype(int) if k else []
    keep = sorted(largest | {rest[j] for j in pick})
    return [pairs[i] for i in keep]


def check_traceback(pairs, dev):
    """The C batch traceback against the Python spec (align.banded_sw +
    _mark_mismatch) on a sample of phase 5's round-1 pairs, located by the
    SSW kernels as the route locates them; the C entry's time on 1 thread
    and on every core, and the spec's."""
    import ribbit_tpu_torch.refine_batched as rb
    from ribbit_tpu_torch import align

    sample = sample_pairs(pairs)
    aligns = rb._device_align(sample, dev)
    located = [(p, al) for p, al in zip(sample, aligns)
               if al is not None and al.ref_end >= 0]
    loc = [np.array([getattr(al, f) for _, al in located]) for f in
           ("sw_score", "ref_begin", "ref_end", "query_begin", "query_end")]
    got = [(al.cigar_string, al.mismatches) for _, al in located]
    times = {}
    for threads in (1, os.cpu_count() or 1):
        t = time.perf_counter()
        cigars, mism = align.traceback_batch([p for p, _ in located], *loc,
                                             nthreads=threads)
        times[threads] = time.perf_counter() - t
        if list(zip(cigars, mism.tolist())) != got:
            raise AssertionError(f"the C traceback on {threads} threads "
                                 "differs from the route's")
    t = time.perf_counter()
    bad = 0
    for ((read, ref), al), want in zip(located, got):
        sub_ref = ref[al.ref_begin:al.ref_end + 1]
        sub_read = read[al.query_begin:al.query_end + 1]
        ops = align.banded_sw(sub_ref, sub_read, al.sw_score,
                              abs(sub_ref.shape[0] - sub_read.shape[0]) + 1)
        bad += align._mark_mismatch(al, ref, read, read.shape[0],
                                    ops) != want
    spec_s = time.perf_counter() - t
    cells = sum((al.ref_end - al.ref_begin + 1)
                * (al.query_end - al.query_begin + 1) for _, al in located)
    log(f"  C traceback against the Python spec on {len(located)} located "
        f"round-1 pairs (the 10 largest among them, {cells} located cells): "
        f"{bad} differ; C {times[1] * 1e3:.1f} ms on 1 thread, "
        + ", ".join(f"{v * 1e3:.1f} ms on {k}" for k, v in times.items()
                    if k != 1)
        + f"; the spec {spec_s:.2f} s")
    if bad:
        raise AssertionError(f"the C traceback differs from the Python spec "
                             f"on {bad} pairs")


ROUTE_STEPS = ("requests", "H2D", "forward", "reverse build", "terminate",
               "traceback", "emit", "order")


@contextlib.contextmanager
def route_split():
    """The batched route's steps timed while the block runs (each ends in
    a synchronize): a dict of seconds a step (ROUTE_STEPS) and a list of
    rounds, each (forward pairs, their cells, terminate pairs, their
    cells)."""
    import ribbit_tpu_torch.refine_batched as rb
    from ribbit_tpu_torch import align_kernels as ak
    from ribbit_tpu_torch.core import CoreSession

    spent = dict.fromkeys(ROUTE_STEPS, 0.0)
    rounds = []
    calls = 0

    def timed(key, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                return out
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapped

    def forward(p, devices):
        nonlocal calls
        key = ("forward", "terminate")[calls % 2]
        calls += 1
        cells = int((p.rlen * p.clen).sum())
        if key == "forward":
            rounds.append([p.n, cells])
        else:
            rounds[-1] += [p.n, cells]
        return timed(key, real["_forward"])(p, devices)

    real = {"_forward": rb._forward, "_reverse_pairs": rb._reverse_pairs,
            "traceback_flat": rb.traceback_flat, "_order": rb._order,
            "pack_flat": ak.pack_flat,
            "round_requests": CoreSession.round_requests,
            "round_emit": CoreSession.round_emit}
    rb._forward = forward
    rb._reverse_pairs = timed("reverse build", real["_reverse_pairs"])
    rb.traceback_flat = timed("traceback", real["traceback_flat"])
    rb._order = timed("order", real["_order"])
    ak.pack_flat = timed("H2D", real["pack_flat"])
    CoreSession.round_requests = timed("requests", real["round_requests"])
    CoreSession.round_emit = timed("emit", real["round_emit"])
    try:
        yield spent, rounds
    finally:
        for name in ("_forward", "_reverse_pairs", "traceback_flat",
                     "_order"):
            setattr(rb, name, real[name])
        ak.pack_flat = real["pack_flat"]
        CoreSession.round_requests = real["round_requests"]
        CoreSession.round_emit = real["round_emit"]


def split_text(spent: dict, wall: float) -> str:
    return (", ".join(f"{k} {v:.3f} s" for k, v in spent.items())
            + f", the rest {wall - sum(spent.values()):.3f} s")


def ssw_launches() -> dict:
    from ribbit_tpu_torch import align_kernels as ak
    return {"ssw_forward_small": ak.ssw_forward_small.launches,
            "ssw_forward_large": ak.ssw_forward_large.launches}


def reset_ssw_launches():
    from ribbit_tpu_torch import align_kernels as ak
    ak.ssw_forward_small.launches = 0
    ak.ssw_forward_large.launches = 0


def route_run(what: str, fn):
    """fn() with the SSW launch counts set to 0 and the route's steps
    timed; logs the launches, rounds and split.  Returns (fn's result,
    wall s, launches)."""
    reset_ssw_launches()
    with route_split() as (spent, rounds):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    got = ssw_launches()
    log(f"  {what}: {wall:.3f} s, launches {got}, {len(rounds)} rounds "
        f"(forward pairs, cells, terminate pairs, cells): {rounds}")
    log(f"    split: {split_text(spent, wall)}")
    if min(got.values()) <= 0:
        raise AssertionError(f"an SSW kernel was not launched: {got}")
    return out, wall, got, spent


def route_abba(seq: str, cfg, dev, rounds: int, want) -> dict:
    """pipeline.process_sequence (extraction, replay and refinement) on
    the gpu backend without (A) and with (B) RIBBIT_BATCHED_REFINE=1, the
    C pool against refine_batched, in `rounds` rounds of A B B A, each BED
    against `want`; the wall time of each run and of its refinement step
    (sess.refine or refine_batched, the only code that differs).  Logs
    each side's median and the pairs the route won; returns the times."""
    import ribbit_tpu_torch.refine_batched as rb
    from ribbit_tpu_torch.core import CoreSession
    from ribbit_tpu_torch.pipeline import process_sequence

    out = {w: {"wall": [], "refine": []} for w in ("C pool", "route")}
    real = {"pool": CoreSession.refine, "route": rb.refine_batched}
    spent = []

    def timed(fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t0)
        return wrapped

    CoreSession.refine = timed(real["pool"])
    rb.refine_batched = timed(real["route"])
    try:
        for k, who in enumerate(("C pool", "route", "route", "C pool")
                                * rounds):
            spent.clear()
            if who == "route":
                os.environ["RIBBIT_BATCHED_REFINE"] = "1"
            try:
                t = time.perf_counter()
                lines = process_sequence("route", seq, cfg, device=dev)
                torch.cuda.synchronize()
                out[who]["wall"].append(time.perf_counter() - t)
            finally:
                os.environ.pop("RIBBIT_BATCHED_REFINE", None)
            out[who]["refine"].append(sum(spent))
            same_bed(lines, want, f"the host route ({who}, run {k})")
    finally:
        CoreSession.refine = real["pool"]
        rb.refine_batched = real["route"]
    for key in ("wall", "refine"):
        c, r = out["C pool"][key], out["route"][key]
        log(f"  process_sequence on {len(seq)} bp, {rounds} x A B B A, "
            f"{key}: C pool {c}, median {float(np.median(c)):.4f} s; route "
            f"{r}, median {float(np.median(r)):.4f} s; the route faster in "
            f"{sum(b < a for a, b in zip(c, r))} of {2 * rounds} pairs")
    return out


def phase_batched(seq: str, cfg, dev, pairs, chr21):
    """refine_batched, the JAX package's single-contig device route: the
    CLI on the route contig with RIBBIT_BATCHED_REFINE=1 against the host
    route; process_sequence without and with the variable in ROUTE_ABBA
    rounds of A B B A on that contig (route_abba);
    refine_batched and the C pool in C R R C over one replayed session of
    that contig; on chr21 over phase 4's replayed session, against the
    host route's chr21 lines and beside phase 4's C-pool refinement; each
    route run's launches (its own, counted from 0), rounds and split; then
    the C traceback against the Python spec on a sample of phase 5's
    round-1 pairs.  Returns the K3/K4 launches of the CLI run, and those
    of the other route runs by run."""
    import ribbit_tpu_torch.refine_batched as rb
    from ribbit_tpu_torch.cli import main as cli_main
    from ribbit_tpu_torch.core import CoreSession
    from ribbit_tpu_torch.encode import encode
    from ribbit_tpu_torch.pipeline import extract_events

    launches = {}                # the CLI run's
    others = {}                  # run -> the other route runs' launches

    def add(run, got):
        for name, n in got.items():
            others.setdefault(name, {})[run] = n

    with tempfile.TemporaryDirectory(prefix="ribbit_smoke_") as tmp:
        fa = os.path.join(tmp, "route.fa")
        write_fasta(fa, [("route", seq)])
        beds = {}
        for route in ("host", "gpu"):
            out = os.path.join(tmp, f"{route}.bed")
            argv = ["--backend", route, "--device", str(dev), "-i", fa,
                    "-o", out]
            if route == "host":
                t = time.perf_counter()
                rc = cli_main(argv)
                log(f"  --backend host: {time.perf_counter() - t:.3f} s")
            else:
                os.environ["RIBBIT_BATCHED_REFINE"] = "1"
                try:
                    rc, _, launches, spent = route_run(
                        "--backend gpu with RIBBIT_BATCHED_REFINE=1",
                        lambda: cli_main(argv))
                finally:
                    os.environ.pop("RIBBIT_BATCHED_REFINE", None)
                if spent["traceback"] > TRACEBACK_MAX_S:
                    raise AssertionError(
                        f"the C traceback took {spent['traceback']:.2f} s,"
                        f" above {TRACEBACK_MAX_S} s")
            if rc != 0:
                raise AssertionError(f"the {route} route exited {rc}")
            with open(out) as fh:
                beds[route] = fh.read().splitlines()
    same_bed(beds["gpu"], beds["host"], "the host route")

    route_abba(seq, cfg, dev, ROUTE_ABBA, beds["host"])

    code, n_mask = encode(seq)
    sess = CoreSession(code, n_mask, cfg, nthreads=os.cpu_count() or 1)
    try:
        sess.set_events(*extract_events(code, n_mask, cfg, dev))
        seeds = sess.scan()
        times = {"C pool": [], "route": []}
        for k, who in enumerate(("C pool", "route", "route", "C pool")):
            if who == "route":
                lines, wall, got, _ = route_run(
                    f"refinement run {k}, refine_batched",
                    lambda: rb.refine_batched(seeds, seq, "route", code,
                                              n_mask, sess, cfg, device=dev))
                add(f"C R R C run {k}", got)
            else:
                t = time.perf_counter()
                lines = sess.refine(seeds, seq, "route")
                wall = time.perf_counter() - t
            times[who].append(wall)
            same_bed(lines, beds["host"], f"the host route ({who}, run {k})")
    finally:
        sess.close()
    log(f"  refinement of {len(seq)} bp, C R R C: "
        + "; ".join(f"{k} {v}" for k, v in times.items()))

    sess, seeds, chrom, want, c_refine_s = chr21
    lines, wall, got, _ = route_run(
        f"chr21 ({len(chrom)} bp, {len(seeds)} seeds), refine_batched",
        lambda: rb.refine_batched(seeds, chrom, "chr21", sess.code,
                                  sess.n_mask, sess, cfg, device=dev))
    add("chr21", got)
    log(f"  chr21: refine_batched {wall:.2f} s against phase 4's C-pool "
        f"refinement {c_refine_s:.2f} s")
    same_bed(lines, want, "the host route's chr21 lines (phase 4)")
    check_traceback(pairs, dev)
    return launches, others


def word_bits_err(planes, words, cfg) -> int:
    """Positions where the q7, q6 or pm plane of a motif row differs from
    that row's bit of the event words."""
    q7, q6, _, pm = planes
    r0 = cfg.min_motif - cfg.min_shift
    bad = 0
    for k in range(cfg.nmotifs):
        g, bit = divmod(r0 + k, 8)
        for plane, field in ((q6, 0), (q7, 1), (pm, 2)):
            b = (words[g] >> (8 * field + bit)) & 1
            bad += int((plane[k].to(torch.int32) != b).sum())
    return bad


def phase_dense_kernel(se, sm, cases, cfgs, dev, rate):
    """dense_masks against its plain version and the event words' bits,
    bit-equal; time, share of the bound and GB/s at the segment shape at
    every configuration (the first one's go to the kernels line)."""
    from ribbit_tpu_torch.encode import encode

    err, stats, seg = 0, None, {}
    for cfg in cfgs:
        tag = f"m{cfg.min_motif}-M{cfg.max_motif}"
        for name, seq in cases:
            code, n_mask = encode(seq)
            c = torch.from_numpy(code.view(np.uint8)).to(dev)
            n = torch.from_numpy(n_mask.view(np.uint8)).to(dev)
            a = se.anchor_planes(c, cfg)
            got = sm.masks(c, n, a, cfg)
            want = sm.masks_ref(c, n, a, cfg)
            # 32 rows at a time: at -M 300 a plane of the segment is 2.5 GB
            e = max(max_abs_err(g[i:i + 32], w[i:i + 32])
                    for g, w in zip(got, want) for i in range(0, len(g), 32))
            del want
            ov = torch.empty(cfg.nmotifs, se.overlay_row_words(len(seq)),
                             dtype=torch.int32, device=dev)
            e_bits = word_bits_err(got, se.event_words(c, n, a, cfg, ov), cfg)
            torch.cuda.synchronize()
            log(f"  {tag} {name} L={len(seq)}: dense_masks err {e}, "
                f"{e_bits} positions off the event words' bits; "
                f"{[int(p.sum()) for p in got]} set in (q7, q6, ps, pm)")
            err = max(err, e)
            if e or e_bits:
                raise AssertionError(f"dense_masks != plain version or the "
                                     f"event words ({tag} {name}: {e}, "
                                     f"{e_bits})")
            del got
            if name == "segment":
                ms = cuda_ms(lambda: sm.masks(c, n, a, cfg), KERNEL_REPS)
                work = br.scan_work("dense_masks", len(seq), cfg)
                bms, by = bound(*work, rate)
                seg[tag] = (ms, bms, by, work[0])
                if cfg is cfgs[0]:
                    plain_ms = cuda_ms(lambda: sm.masks_ref(c, n, a, cfg),
                                       PLAIN_REPS)
                    stats = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by)
            del a
    log(f"  dense_masks at the segment shape: plain "
        f"{stats['plain_ms']:.3f} ms ({stats['plain_ms'] / stats['ms']:.1f}x "
        "the kernel)")
    for tag, (ms, bms, by, nbytes) in seg.items():
        log(f"  dense_masks at the segment shape, {tag}: kernel {ms:.4f} ms, "
            f"bound {bms:.4f} ms by {by} ({bms / ms:.1%} of it), "
            f"{nbytes / ms / 1e6:.1f} GB/s")
    return stats


def same_streams(got, want, what: str):
    """Raise unless two (perfect, q7, q6) stream triples are identical."""
    for k, sname in enumerate(("perfect", "q7", "q6")):
        for a, b, part in zip(got[k], want[k], ("starts", "ends",
                                                 "offsets")):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: {sname} {part} differ")
    log(f"  {what}: streams identical ({sum(len(g[0]) for g in got)} "
        "events)")


def phase_dense_path(sm, genome, cfg, dev, want_bed):
    """The dense path end to end: every contig's events from the dense
    planes (scan_events_via_masks, segment by segment, stitched), replayed
    and refined by the C core; chr21's streams against the event path's,
    the BED against phase 4's."""
    from functools import partial

    from ribbit_tpu_torch.core import CoreSession
    from ribbit_tpu_torch.encode import encode
    from ribbit_tpu_torch.eventstitch import scan_events_segmented
    from ribbit_tpu_torch.pipeline import SEG_SIZE, extract_events

    lines, spent = [], {"segments": 0.0, "stitching": 0.0, "replay": 0.0,
                        "refinement": 0.0}
    extractor = partial(sm.scan_events_via_masks, device=dev)

    def timed_extractor(*a):
        t0 = time.perf_counter()
        try:
            return extractor(*a)
        finally:
            spent["segments"] += time.perf_counter() - t0

    checked = 0.0
    sm.masks.launches = 0
    t_all = time.perf_counter()
    for name, seq in genome:
        code, n_mask = encode(seq)
        t = time.perf_counter()
        seg0 = spent["segments"]
        got = scan_events_segmented(code, n_mask, cfg,
                                    extractor=timed_extractor,
                                    seg_size=SEG_SIZE)
        spent["stitching"] += (time.perf_counter() - t
                               - (spent["segments"] - seg0))
        if name == "chr21":
            t = time.perf_counter()
            same_streams(got, extract_events(code, n_mask, cfg, dev),
                         "chr21, dense path against the event path")
            checked = time.perf_counter() - t
        sess = CoreSession(code, n_mask, cfg, nthreads=os.cpu_count() or 1)
        try:
            t = time.perf_counter()
            sess.set_events(*got)
            seeds = sess.scan()
            spent["replay"] += time.perf_counter() - t
            t = time.perf_counter()
            lines += sess.refine(seeds, seq, name)
            spent["refinement"] += time.perf_counter() - t
        finally:
            sess.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all - checked
    launches = sm.masks.launches
    log(f"  launches in the dense run: dense_masks {launches}")
    if launches <= 0:
        raise AssertionError("dense_masks was not launched")
    same_bed(lines, want_bed, "phase 4's --backend gpu BED")
    log(f"  dense path {wall:.2f} s (without the stream check): segments "
        f"(H2D, kernels, device epilogue, events D2H) "
        f"{spent['segments']:.2f} s, stitching {spent['stitching']:.2f} s, "
        f"C replay {spent['replay']:.2f} s, C refinement "
        f"{spent['refinement']:.2f} s")
    return launches


def phase_probe_bench(dev, rate):
    """alu_probe against its plain version, bit-equal, its SASS count and
    rate; then the port's bench, whose launches are counted."""
    from ribbit_tpu_torch import align_kernels as ak
    from ribbit_tpu_torch import bench_device as bd
    from ribbit_tpu_torch import scan_events as se
    from ribbit_tpu_torch import scan_masks as sm

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-2**31, 2**31 - 1, (br.ROWS * br.WIDTH,), generator=g,
                      dtype=torch.int32, device=dev)
    plain_ms = cuda_ms(lambda: br.alu_probe_ref(x, br.OPS, br.TRIPS), 1)
    # the full depth; one loop body as trips of one round; two bodies as
    # the rounds of one trip
    unroll = br.probe_unroll()
    err = 0
    for ops, trips in ((br.OPS, br.TRIPS), (br.CHAINS, unroll),
                       (br.CHAINS * 2 * unroll, 1)):
        e = max_abs_err(br.alu_probe(x, ops, trips),
                        br.alu_probe_ref(x, ops, trips))
        log(f"  alu_probe at ops {ops} x trips {trips} on "
            f"({br.ROWS}, {br.WIDTH}): err {e}")
        err = max(err, e)
    if err:
        raise AssertionError("alu_probe != plain version")
    probe = br.probe_ceiling(dev)
    log(f"  SASS loop body ({probe['loop_rounds']} rounds, "
        f"{probe['loop_rounds'] * br.CHAINS} source operations): "
        f"{probe['sass_loop_instructions']} integer instructions "
        f"{probe['sass_loop_opcodes']}, {probe['insns_per_op']:.4f} a "
        f"source operation (folding guard: passed)")
    log(f"  alu_probe {probe['ms']:.4f} ms: {probe['int32_tops']:.3f} Tops/s "
        f"= {probe['spec_frac']:.1%} of the spec {probe['spec_tops']:.3f} "
        f"(limit {br.PROBE_LIMIT:.0%}: passed)")
    reps = max(br.PROBE_REPS, int(CLOCK_WINDOW_MS / probe["ms"]))
    ms, clocks = br.sm_clocks(lambda: cuda_ms(
        lambda: br.alu_probe(x, br.OPS, br.TRIPS), reps))
    if not clocks:
        raise AssertionError("no SM clock sample during the probe's reps")
    log(f"  alu_probe over {reps} reps: {ms:.4f} ms; SM clock (nvidia-smi, "
        f"{len(clocks)} samples) min {min(clocks):.0f}, max "
        f"{max(clocks):.0f} MHz; clocks.max.sm {br.smi('clocks.max.sm')} MHz")
    bms, by = bound(*br.probe_work(x.numel()), rate)

    for fn in (br.alu_probe, sm.masks, se.anchor_planes, se.event_words,
               ak.ssw_forward_small):
        fn.launches = 0
    t = time.perf_counter()
    res = bd.run_device_bench(dev)
    wall = time.perf_counter() - t
    launches = br.alu_probe.launches
    log(f"  bench_device in {wall:.1f} s; launches: alu_probe {launches}, "
        f"dense_masks {sm.masks.launches}, ssw_forward_small "
        f"{ak.ssw_forward_small.launches}")
    missing = [key for key, v in res.items() if v is None]
    if missing or launches <= 0:
        raise AssertionError(f"bench_device: no value for {missing}, "
                             f"{launches} probe launches")
    log(json.dumps(res))
    return launches, dict(max_abs_err=err, ms=probe["ms"],
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def phase_eq_sum8(sd, cases, cfgs, dev, rate):
    """eq_sum8 against its plain version, bit-equal on both outputs; time
    and bound at the segment shape."""
    from ribbit_tpu_torch.config import RibbitConfig
    from ribbit_tpu_torch.encode import encode

    big = RibbitConfig.create(max_motif=BIG_M)
    runs = [(cfg, case) for cfg in cfgs for case in cases]
    runs += [(big, case) for case in cases if case[0] != "segment"]
    err, stats = 0, None
    for cfg, (name, seq) in runs:
        tag = f"m{cfg.min_motif}-M{cfg.max_motif}"
        c = torch.from_numpy(encode(seq)[0].view(np.uint8)).to(dev)
        got = sd.eq_sum8(c, cfg)
        want = sd.eq_sum8_ref(c, cfg)
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        torch.cuda.synchronize()
        log(f"  {tag} {name} L={len(seq)}: eq_sum8 err {e}; "
            f"{int(got[0].sum())} matches")
        err = max(err, e)
        if e:
            raise AssertionError(f"eq_sum8 != plain version ({tag} {name}: "
                                 f"{e})")
        del got, want
        if name == "segment" and cfg is cfgs[0]:
            ms = cuda_ms(lambda: sd.eq_sum8(c, cfg), KERNEL_REPS)
            plain_ms = cuda_ms(lambda: sd.eq_sum8_ref(c, cfg), PLAIN_REPS)
            bms, by = bound(*br.scan_work("eq_sum8", len(seq), cfg), rate)
            stats = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by)
    stats["max_abs_err"] = err
    log(f"  eq_sum8 at the segment shape: kernel {stats['ms']:.3f} ms, "
        f"plain {stats['plain_ms']:.3f} ms "
        f"({stats['plain_ms'] / stats['ms']:.1f}x), bound "
        f"{stats['bound_ms']:.4f} ms by {stats['bound_by']}")
    return stats


def _timed(spent: dict, key: str, fn):
    """fn, with its wall time added to spent[key] on each call."""
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent[key] += time.perf_counter() - t0
    return wrapped


def phase_python_engine(sd, se, seq: str, cfg, dev):
    """The dense scan on the card against the numpy spec, then the Python
    engine end to end against the C core; launches and the time split."""
    from ribbit_tpu_torch import host
    from ribbit_tpu_torch import pipeline as pl
    from ribbit_tpu_torch.encode import encode

    code, n_mask = encode(seq)
    t = time.perf_counter()
    got = sd.scan_arrays(code, n_mask, cfg, device=dev)
    scan_s = time.perf_counter() - t
    t = time.perf_counter()
    spec = host.scan_host_arrays(code, n_mask, cfg)
    spec_s = time.perf_counter() - t
    for name, g, w in zip(("eq", "anchors", "overlay", "qual7", "qual6"),
                          got, spec):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"scan_arrays' {name} differs from the "
                                 "numpy spec")
    log(f"  scan_arrays on the card equals the numpy spec on all five "
        f"arrays ({sum(g.nbytes for g in got) / 1e6:.1f} MB; card "
        f"{scan_s:.2f} s with the copies to the host, numpy "
        f"{spec_s:.2f} s)")
    del got, spec

    spent = {"device scan": 0.0, "scanners and lattices": 0.0,
             "refinement": 0.0}
    saved = (sd.scan_arrays, host.python_seeds, host._refine_seeds)
    sd.scan_arrays = _timed(spent, "device scan", saved[0])
    host.python_seeds = _timed(spent, "scanners and lattices", saved[1])
    host._refine_seeds = _timed(spent, "refinement", saved[2])
    sd.eq_sum8.launches = 0
    se.anchor_planes.launches = 0
    try:
        t = time.perf_counter()
        lines = pl.process_sequence("route", seq, cfg, device=dev,
                                    engine="python")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        sd.scan_arrays, host.python_seeds, host._refine_seeds = saved
    launches = {"eq_sum8": sd.eq_sum8.launches,
                "anchor_planes": se.anchor_planes.launches}
    log(f"  launches in the engine's run: {launches}")
    if launches != {"eq_sum8": 1, "anchor_planes": 1}:
        raise AssertionError(f"want one launch of each kernel for the "
                             f"contig, got {launches}")
    t = time.perf_counter()
    want = host.process_sequence("route", seq, cfg)
    core_s = time.perf_counter() - t
    same_bed(lines, want, "the port's host route (the C core)")
    rest = wall - sum(spent.values())
    log(f"  Python engine {wall:.2f} s on {len(seq)} bp "
        f"({len(seq) / wall / 1e3:.1f} kbp/s): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in spent.items())
        + f", the rest {rest:.2f} s; the C core {core_s:.2f} s")
    return launches["eq_sum8"]


def parallel_chr21(se, chrom: str, cfg, devs):
    """distributed_process_contig on chr21's first PAR_CHR21_BP bp at
    PAR_CHUNK bp chunks over `devs`: BED against the host route's on the
    same prefix, K1/K2 launches against the chunk count (above the
    devices'), and the wall time split into extraction, stitching, replay
    and refinement."""
    from ribbit_tpu_torch import host
    from ribbit_tpu_torch.core import CoreSession
    from ribbit_tpu_torch.eventstitch import segment_bounds
    from ribbit_tpu_torch.parallel import distributed as dist_mod

    chrom = chrom[:PAR_CHR21_BP]
    t = time.perf_counter()
    want_bed = host.process_sequence("chr21", chrom, cfg)
    host_s = time.perf_counter() - t
    nchunks = len(segment_bounds(len(chrom), PAR_CHUNK)) - 1
    if nchunks <= len(devs):
        raise AssertionError(f"{nchunks} chunks for {len(devs)} devices")
    spent = dict.fromkeys(("extraction", "stitching", "replay",
                           "refinement"), 0.0)
    saved = (dist_mod._sharded_extract, dist_mod._clip_chunk,
             dist_mod.merge_clipped, CoreSession.set_events,
             CoreSession.scan, CoreSession.refine)
    dist_mod._sharded_extract = _timed(spent, "extraction", saved[0])
    dist_mod._clip_chunk = _timed(spent, "stitching", saved[1])
    dist_mod.merge_clipped = _timed(spent, "stitching", saved[2])
    CoreSession.set_events = _timed(spent, "replay", saved[3])
    CoreSession.scan = _timed(spent, "replay", saved[4])
    CoreSession.refine = _timed(spent, "refinement", saved[5])
    se.anchor_planes.launches = 0
    se.event_words.launches = 0
    try:
        t = time.perf_counter()
        lines = dist_mod.distributed_process_contig(
            "chr21", chrom, cfg, chunk_size=PAR_CHUNK, devices=devs)
        wall = time.perf_counter() - t
    finally:
        (dist_mod._sharded_extract, dist_mod._clip_chunk,
         dist_mod.merge_clipped, CoreSession.set_events, CoreSession.scan,
         CoreSession.refine) = saved
    launches = {"anchor_planes": se.anchor_planes.launches,
                "event_words": se.event_words.launches}
    log(f"  chr21's first {len(chrom)} bp ({nchunks} chunks) over "
        f"{[str(d) for d in devs]}: launches {launches}")
    if set(launches.values()) != {nchunks}:
        raise AssertionError(f"want {nchunks} launches of K1 and K2, got "
                             f"{launches}")
    same_bed(lines, want_bed, "the host route's lines on the prefix")
    log(f"  distributed chr21 prefix {wall:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in spent.items())
        + f", the rest {wall - sum(spent.values()):.2f} s; the host route "
        f"on it {host_s:.2f} s ({len(want_bed)} lines)")
    return launches


def parallel_scan(sd, se, chrom: str, cfg, devs):
    """sharded_scan_step on four 2 Mi-bp chunks of chr21 that hold N runs:
    eq and counts against eq_sum8_ref and the window rule on the card,
    total against their sum, K10 launches against the chunk count."""
    from ribbit_tpu_torch.config import WINDOW_LENGTH
    from ribbit_tpu_torch.encode import encode
    from ribbit_tpu_torch.parallel import sharded_scan_step

    C = SCAN_CHUNK
    code, n_mask = encode(chrom)
    starts = [a for a in range(0, len(chrom) - C + 1, C)
              if n_mask[a:a + C].any()][:SCAN_CHUNKS]
    codes = np.stack([code[a:a + C] for a in starts])
    nmasks = np.stack([n_mask[a:a + C] for a in starts])
    del code, n_mask
    step = sharded_scan_step(devs, cfg)
    sd.eq_sum8.launches = 0
    t = time.perf_counter()
    eq, counts, total = step(codes, nmasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = sd.eq_sum8.launches
    nw = C - WINDOW_LENGTH + 1
    for b in range(len(starts)):
        c = torch.from_numpy(codes[b].view(np.uint8)).to(devs[0])
        n = torch.from_numpy(nmasks[b].view(np.uint8)).to(devs[0])
        eq_r, sum8_r = sd.eq_sum8_ref(c, cfg)
        nfree = se._win8(n)[:nw] == 0
        counts_r = ((sum8_r[:, :nw] >= 7) & nfree).sum(dim=1)
        if not torch.equal(eq[b], eq_r.view(torch.bool)) or \
                not torch.equal(counts[b].to(torch.int64), counts_r):
            raise AssertionError(f"sharded scan chunk {b} (at {starts[b]}) "
                                 "differs from the plain computation")
        del eq_r, sum8_r
    if int(total[0]) != int(counts.sum()):
        raise AssertionError(f"total {int(total[0])} != the counts' sum")
    log(f"  sharded scan, {len(starts)} chunks of {C} bp at {starts} over "
        f"{[str(d) for d in devs]}: eq and counts equal eq_sum8_ref's, "
        f"total {int(total[0])}, {int(nmasks.sum())} N; eq_sum8 launches "
        f"{launches}; step {wall:.3f} s")
    if launches != len(starts):
        raise AssertionError(f"want {len(starts)} eq_sum8 launches, got "
                             f"{launches}")
    return launches


def parallel_forward(pairs, devs):
    """batch_forward_sharded on phase 5's round-1 fits() pairs and their
    terminate-mode pairs, bit-equal on all four outputs to the single-
    device ssw_forward_small; K3 launches."""
    from ribbit_tpu_torch import align_kernels as ak
    from ribbit_tpu_torch.parallel.sharded_refine import \
        batch_forward_sharded

    small = [(r, f) for r, f in pairs if ak.fits(r.shape[0], f.shape[0])]
    reads, refs = [r for r, _ in small], [f for _, f in small]
    ak.ssw_forward_small.launches = 0
    t = time.perf_counter()
    got = batch_forward_sharded(reads, refs, None, devices=devs)
    wall = time.perf_counter() - t
    launches = ak.ssw_forward_small.launches
    want = ak.forward(ak.ssw_forward_small, reads, refs, None, devs[0])
    fwd = np.stack(want)
    rev = reverse_pairs(reads, refs, fwd)
    ak.ssw_forward_small.launches = 0
    got_rev = batch_forward_sharded(*rev, devices=devs)
    launches_rev = ak.ssw_forward_small.launches
    want_rev = ak.forward(ak.ssw_forward_small, *rev, devs[0])
    for what, g, w in (("forward", got, want),
                       ("terminate", got_rev, want_rev)):
        for k, name in enumerate(("score", "end_ref", "end_read",
                                  "first_hit")):
            if not np.array_equal(g[k], w[k]):
                raise AssertionError(f"split {what} forward: {name} "
                                     "differs from the single device's")
    log(f"  split SSW forward over {[str(d) for d in devs]}: {len(reads)} "
        f"round-1 pairs and {len(rev[0])} terminate pairs bit-equal to one "
        f"device; ssw_forward_small launches {launches} + {launches_rev}; "
        f"forward batch {wall:.3f} s")
    if launches != len(devs) or launches_rev != len(devs):
        raise AssertionError(f"want {len(devs)} launches a batch, got "
                             f"{launches} and {launches_rev}")
    return launches + launches_rev


def parallel_refine(seq: str, cfg, devs):
    """refine_batched_sharded over `devs` on a small contig against the
    host route; K3 and K4 launches (the oversized pairs on devs[0])."""
    from ribbit_tpu_torch import align_kernels as ak
    from ribbit_tpu_torch import host
    from ribbit_tpu_torch.core import CoreSession
    from ribbit_tpu_torch.encode import encode
    from ribbit_tpu_torch.parallel.sharded_refine import \
        refine_batched_sharded

    code, n_mask = encode(seq)
    sess = CoreSession(code, n_mask, cfg, nthreads=os.cpu_count() or 1)
    ak.ssw_forward_small.launches = 0
    ak.ssw_forward_large.launches = 0
    try:
        t = time.perf_counter()
        lines = refine_batched_sharded(sess.scan(), seq, "refine", code,
                                       n_mask, sess, cfg, devices=devs)
        wall = time.perf_counter() - t
    finally:
        sess.close()
    launches = {"ssw_forward_small": ak.ssw_forward_small.launches,
                "ssw_forward_large": ak.ssw_forward_large.launches}
    log(f"  refine_batched_sharded on {len(seq)} bp over "
        f"{[str(d) for d in devs]}: {wall:.2f} s, launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"an SSW kernel was not launched: {launches}")
    same_bed(lines, host.process_sequence("refine", seq, cfg),
             "the port's host route")
    return launches


def parallel_multihost(fa: str, want_bed, dev):
    """Two CLI processes on `dev` in one gloo group: both exit 0 within
    MULTIHOST_TIMEOUT, rank 0's BED equals the host route's."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory(prefix="ribbit_smoke_") as tmp:
        out = os.path.join(tmp, "mh.bed")
        procs = []
        try:
            for pid in range(2):
                cmd = [sys.executable, "-m", "ribbit_tpu_torch.cli",
                       "-i", fa, "--device", str(dev), "--coordinator",
                       f"localhost:{port}", "--num-processes", "2",
                       "--process-id", str(pid), "--chunk-size",
                       str(ROUTE_CHUNK), "--timing"]
                if pid == 0:
                    cmd += ["-o", out]
                procs.append(subprocess.Popen(
                    cmd, cwd=root, env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True))
            t = time.perf_counter()
            errs = [p.communicate(timeout=MULTIHOST_TIMEOUT)[1]
                    for p in procs]
            wall = time.perf_counter() - t
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for pid, (p, err) in enumerate(zip(procs, errs)):
            if p.returncode != 0:
                raise AssertionError(f"multihost rank {pid} exited "
                                     f"{p.returncode}:\n{err[-3000:]}")
            for line in err.splitlines():
                if line.startswith(("[p", "Done:")):
                    log(f"  rank {pid}: {line}")
        with open(out) as fh:
            lines = fh.read().splitlines()
    same_bed(lines, want_bed, "the host route (rank 0 of two processes)")
    log(f"  two processes on {dev}: {wall:.2f} s from launch to exit")


def phase_parallel(sd, se, chrom: str, route: str, pairs, cfg, dev):
    """The parallel routes on the card (two shards that share one card):
    distributed chr21, the default device list, the sharded scan, the
    split SSW forward and refinement, and two multi-host processes.
    Returns the kernels' launches in these runs."""
    from ribbit_tpu_torch import host
    from ribbit_tpu_torch.eventstitch import segment_bounds
    from ribbit_tpu_torch.parallel import distributed as dist_mod
    from ribbit_tpu_torch.parallel import make_mesh
    from ribbit_tpu_torch.sim import simulate

    devs = make_mesh(devices=[dev, dev])
    launches = parallel_chr21(se, chrom, cfg, devs)

    mesh = make_mesh()
    route_bed = host.process_sequence("route", route, cfg)
    se.anchor_planes.launches = 0
    se.event_words.launches = 0
    t = time.perf_counter()
    lines = dist_mod.distributed_process_contig("route", route, cfg,
                                                chunk_size=ROUTE_CHUNK)
    wall = time.perf_counter() - t
    got = (se.anchor_planes.launches, se.event_words.launches)
    log(f"  the default device list {[str(d) for d in mesh]} on "
        f"{len(route)} bp at {ROUTE_CHUNK} bp chunks: {wall:.2f} s, "
        f"launches (K1, K2) {got}")
    nchunks = len(segment_bounds(len(route), ROUTE_CHUNK)) - 1
    if got != (nchunks, nchunks):
        raise AssertionError(f"want {nchunks} launches of K1 and K2, got "
                             f"{got}")
    same_bed(lines, route_bed, "the host route")
    for k, n in zip(("anchor_planes", "event_words"), got):
        launches[k] += n

    launches["eq_sum8"] = parallel_scan(sd, se, chrom, cfg, devs)
    launches["ssw_forward_small"] = parallel_forward(pairs, devs)
    small = simulate(num_loci=REFINE_LOCI, seed=ROUTE_SEED,
                     n_block_rate=0.1, name="refine").sequence
    for k, n in parallel_refine(small, cfg, devs).items():
        launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory(prefix="ribbit_smoke_") as tmp:
        fa = os.path.join(tmp, "route.fa")
        write_fasta(fa, [("route", route)])
        parallel_multihost(fa, route_bed, dev)
    log(f"  launches in the parallel routes: {launches}")
    return launches


def capture_votes(name: str, seq: str):
    """(code, n_mask, runs sorted, host G cycles): the vote runs the port's
    host route makes on one contig, from the C core's RIBBIT_VOTE_DUMP
    (one `seed_start ssl m cycles` line per run it votes)."""
    from ribbit_tpu_torch.encode import encode

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="ribbit_smoke_") as tmp:
        fa = os.path.join(tmp, f"{name}.fa")
        dump = os.path.join(tmp, f"{name}.votes")
        write_fasta(fa, [(name, seq)])
        env = dict(os.environ, PYTHONPATH=root, RIBBIT_VOTE_DUMP=dump)
        r = subprocess.run([sys.executable, "-m", "ribbit_tpu_torch.cli",
                            "--backend", "host", "-i", fa, "-o", os.devnull],
                           cwd=root, env=env, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"the host route on {name} exited "
                                 f"{r.returncode}:\n{r.stderr[-3000:]}")
        d = np.loadtxt(dump, dtype=np.int64, ndmin=2)
    runs = sorted((int(a), int(b), int(c)) for a, b, c in d[:, :3])
    code, n_mask = encode(seq)
    return code, n_mask, runs, float(d[:, 3].sum()) / 1e9


def c_voter(code, n_mask, runs, threads: int):
    """(winners, seconds) of the C voter (ribbit_vote_longer) on one thread
    or a pool of them (ctypes releases the GIL during each call)."""
    from ribbit_tpu_torch.native import get_vote_lib

    fn = get_vote_lib().ribbit_vote_longer
    cp = code.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    npp = n_mask.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    L = code.shape[0]

    def one(r):
        return int(fn(cp, npp, L, *r))

    t = time.perf_counter()
    if threads == 1:
        out = [one(r) for r in runs]
    else:
        with ThreadPoolExecutor(threads) as ex:
            out = list(ex.map(one, runs, chunksize=64))
    return out, time.perf_counter() - t


def by_ssl_bucket(vd, runs) -> dict:
    """Run indices by their bucket's padded seed length."""
    out = {}
    for i, (_, ssl, m) in enumerate(runs):
        out.setdefault(vd.bucket_of(ssl, m)[0], []).append(i)
    return dict(sorted(out.items()))


def card_voter(vd, code, n_mask, runs, impl: str, dev):
    """Winners of vote_longer_batch on the card, one timed call per ssl
    bucket after a one-run warm-up, and per bucket: runs, batches, the
    call's wall time (packing, copies, walks and prefix votes), the CUDA
    events' span around its bucket kernels, walk steps and overflows."""
    name = "_vote_bucket" if impl == "banded" else "_vote_bucket_spec"
    kern = getattr(vd, name)
    spans = []

    def evented(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kern(*a, **kw)
        e1.record()
        spans.append((e0, e1))
        return out

    out = [0] * len(runs)
    stats = {}
    setattr(vd, name, evented)
    try:
        for ssl_pad, idxs in by_ssl_bucket(vd, runs).items():
            part = [runs[i] for i in idxs]
            vd.vote_longer_batch(code, n_mask, part[:1], impl=impl,
                                 device=dev)
            torch.cuda.synchronize()
            spans.clear()
            steps = vd.vote_longer_batch.steps
            ovf = vd.vote_longer_batch.overflows
            t = time.perf_counter()
            got = vd.vote_longer_batch(code, n_mask, part, impl=impl,
                                       device=dev)
            wall = time.perf_counter() - t
            torch.cuda.synchronize()
            stats[ssl_pad] = {
                "runs": len(part), "batches": len(spans),
                "wall_ms": wall * 1e3,
                "device_ms": sum(a.elapsed_time(b) for a, b in spans),
                "steps": vd.vote_longer_batch.steps - steps,
                "overflows": vd.vote_longer_batch.overflows - ovf}
            for i, g in zip(idxs, got):
                out[i] = g
    finally:
        setattr(vd, name, kern)
    return out, stats


def c_by_bucket(vd, code, n_mask, runs) -> dict:
    """The C voter's time per ssl bucket, on one thread and on
    VOTE_THREADS."""
    out = {}
    for ssl_pad, idxs in by_ssl_bucket(vd, runs).items():
        part = [runs[i] for i in idxs]
        out[ssl_pad] = {"c1_ms": c_voter(code, n_mask, part, 1)[1] * 1e3,
                        "c8_ms": c_voter(code, n_mask, part,
                                         VOTE_THREADS)[1] * 1e3}
    return out


def same_winners(got, want, runs, what: str):
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if len(got) != len(want) or bad:
        i = bad[0] if bad else min(len(got), len(want))
        raise AssertionError(f"{what}: {len(bad)} winner(s) differ from the "
                             f"C voter's, first run {runs[i]}: "
                             f"{got[i] if i < len(got) else None} vs "
                             f"{want[i] if i < len(want) else None}")
    log(f"  {what}: all {len(got)} winners equal the C voter's")


def planted_vote(m: int, perfect: bool, seed: int = 5):
    """(code, n_mask, run): a tandem repeat of an m bp unit around a run of
    ssl = 3m + 17 at seed_start 10, exact or with a substitution, shift or
    N at every twelfth position."""
    rng = np.random.default_rng(seed + m)
    ss, ssl = 10, 3 * m + 17
    L = ss + ssl + m + 40
    unit = rng.integers(0, 4, m, dtype=np.int8)
    code = np.tile(unit, L // m + 1)[:L].copy()
    n_mask = np.zeros(L, dtype=bool)
    if not perfect:
        pos = rng.choice(L, size=L // 12, replace=False)
        kind = rng.integers(0, 3, pos.size)
        code[pos[kind == 0]] = rng.integers(0, 4, int((kind == 0).sum()))
        for p in pos[kind == 1][:4]:
            code[p:] = np.roll(code[p:], 1)
        n_mask[pos[kind == 2]] = True
    return code, n_mask, (ss, ssl, m)


def log_voter_table(stats: dict, cstats: dict, label: str):
    log(f"  {label}: ssl bucket, runs, batches, card wall ms, device span "
        "ms, walk steps, overflows, C voter ms on 1 and "
        f"{VOTE_THREADS} threads")
    for ssl_pad, s in stats.items():
        c = cstats[ssl_pad]
        log(f"    {ssl_pad:5d} {s['runs']:6d} {s['batches']:5d} "
            f"{s['wall_ms']:10.2f} {s['device_ms']:10.2f} {s['steps']:7d} "
            f"{s['overflows']:3d} {c['c1_ms']:9.2f} {c['c8_ms']:9.2f}")


def phase_voter(chrom: str, route: str, dev) -> dict:
    """The device-batched voter against the C voter on the host route's
    call sets (phase 5's contig whole, a chr21 sample) and on planted
    large motifs; returns the {"voter": ...} line's object."""
    from ribbit_tpu_torch import vote_device as vd

    sets = {}
    for name, seq in (("route", route), ("chr21", chrom)):
        t = time.perf_counter()
        sets[name] = capture_votes(name, seq)
        log(f"  {name} ({len(seq)} bp): {len(sets[name][2])} vote runs of "
            f"the host route ({sets[name][3]:.2f} G host cycles in the "
            f"dump), captured in {time.perf_counter() - t:.1f} s")

    # phase 5's contig: every run through both walks (spec up to ssl 1024)
    code, n_mask, runs, gc = sets["route"]
    want, c1_s = c_voter(code, n_mask, runs, 1)
    _, c8_s = c_voter(code, n_mask, runs, VOTE_THREADS)
    got, banded = card_voter(vd, code, n_mask, runs, "banded", dev)
    same_winners(got, want, runs, "route set, impl=banded")
    keep = [i for i, r in enumerate(runs)
            if vd.bucket_of(r[1], r[2])[0] <= VOTE_SPEC_MAX_SSL]
    spec_runs = [runs[i] for i in keep]
    got, spec = card_voter(vd, code, n_mask, spec_runs, "spec", dev)
    same_winners(got, [want[i] for i in keep], spec_runs,
                 f"route set up to ssl {VOTE_SPEC_MAX_SSL}, impl=spec")
    cstats = c_by_bucket(vd, code, n_mask, runs)
    log_voter_table(banded, cstats, "route set, impl=banded")
    log_voter_table(spec, cstats, "route set, impl=spec")
    card_s = sum(s["wall_ms"] for s in banded.values()) / 1e3
    ovf = sum(s["overflows"] for s in banded.values())
    log(f"  route set: card (banded) {card_s:.3f} s, {ovf} band "
        f"overflow(s) re-voted on the host; C voter {c1_s:.3f} s on 1 "
        f"thread, {c8_s:.3f} s on {VOTE_THREADS}")
    route_out = {"bp": len(route), "runs": len(runs), "host_gcycles": gc,
                 "banded": banded, "spec": spec, "c_voter": cstats,
                 "card_s": card_s, "overflows": ovf, "c1_s": c1_s,
                 "c8_s": c8_s}

    # chr21: evenly spaced sample of VOTE_SAMPLE_BATCHES batches a bucket
    code, n_mask, runs, gc = sets["chr21"]
    want, c8_s = c_voter(code, n_mask, runs, VOTE_THREADS)
    buckets = by_ssl_bucket(vd, runs)
    sample = []
    for ssl_pad, idxs in buckets.items():
        k = VOTE_SAMPLE_BATCHES * vd.batch_size_of(ssl_pad)
        sample += (idxs if len(idxs) <= k else
                   [idxs[i] for i in np.linspace(0, len(idxs) - 1, k)
                    .astype(int)])
    s_runs = [runs[i] for i in sample]
    got, st = card_voter(vd, code, n_mask, s_runs, "banded", dev)
    same_winners(got, [want[i] for i in sample], s_runs,
                 "chr21 sample, impl=banded")
    cstats = c_by_bucket(vd, code, n_mask, s_runs)
    log_voter_table(st, cstats, "chr21 sample, impl=banded")
    extrap = {}
    for ssl_pad, s in st.items():
        f = len(buckets[ssl_pad]) / s["runs"]
        extrap[ssl_pad] = {"runs": len(buckets[ssl_pad]),
                           "card_s": s["wall_ms"] * f / 1e3,
                           "c1_s": cstats[ssl_pad]["c1_ms"] * f / 1e3}
    card_s = sum(e["card_s"] for e in extrap.values())
    c1_s = sum(e["c1_s"] for e in extrap.values())
    log("  chr21, extrapolated from the sample by run count per bucket: "
        + ", ".join(f"{p}: card {e['card_s']:.2f} s, C {e['c1_s']:.2f} s"
                    for p, e in extrap.items()))
    log(f"  chr21 ({len(runs)} runs): card (banded) {card_s:.1f} s "
        f"extrapolated, C voter {c1_s:.2f} s on 1 thread extrapolated, "
        f"{c8_s:.2f} s measured on {VOTE_THREADS} threads over all runs")
    chr21_out = {"bp": len(chrom), "runs": len(runs), "host_gcycles": gc,
                 "sampled": len(s_runs), "banded": st, "c_voter": cstats,
                 "extrapolated": extrap, "card_s_extrapolated": card_s,
                 "c1_s_extrapolated": c1_s, "c8_s": c8_s}

    planted = []
    for m, perfect in [(m, False) for m in VOTE_PLANTED_M] + [(300, True)]:
        code, n_mask, run = planted_vote(m, perfect)
        want = c_voter(code, n_mask, [run], 1)[0]
        for impl in vd.IMPLS:
            got = vd.vote_longer_batch(code, n_mask, [run], impl=impl,
                                       device=dev)
            if got != want:
                raise AssertionError(f"planted m = {m} (perfect {perfect}), "
                                     f"impl={impl}: {got} vs the C voter's "
                                     f"{want}")
        planted.append({"m": m, "run": run, "perfect": perfect,
                        "winner": want[0]})
    log(f"  planted runs at m = {VOTE_PLANTED_M} and a perfect m = 300: "
        "both walks equal the C voter")
    return {"card": br.card_name(), "route": route_out, "chr21": chr21_out,
            "planted": planted}


def route_choice(rounds: int) -> int:
    """The build, then phase 6's A B B A of process_sequence alone, at
    `rounds` rounds on the route contig, against the host route's BED."""
    from ribbit_tpu_torch import host
    from ribbit_tpu_torch.config import RibbitConfig
    from ribbit_tpu_torch.sim import simulate

    dev = torch.device("cuda", 0)
    log(br.card_name())
    phase_build()
    cfg = RibbitConfig.create()
    seq = simulate(num_loci=ROUTE_LOCI, seed=ROUTE_SEED, n_block_rate=0.1,
                   name="route").sequence
    out = route_abba(seq, cfg, dev, rounds,
                     host.process_sequence("route", seq, cfg))
    log(json.dumps({"route_abba": out, "card": br.card_name()}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if argv:
        if len(argv) != 2 or argv[0] != "--route-abba":
            print("usage: chip_smoke.py [--route-abba ROUNDS]",
                  file=sys.stderr)
            return 2
        return route_choice(int(argv[1]))
    import ribbit_tpu_torch.scan_dense as sd
    import ribbit_tpu_torch.scan_events as se
    import ribbit_tpu_torch.scan_masks as sm
    from ribbit_tpu_torch import cuda_build
    from ribbit_tpu_torch.config import RibbitConfig
    from ribbit_tpu_torch.sim import simulate

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = br.card_name()
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}, python "
        f"{sys.version.split()[0]}")
    rate = br.spec_int32_rate(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"    int32 peak: {sms} SMs x {br.ISSUE_LANES_PER_SM} issue lanes x "
        f"the maximum SM clock = {rate / 1e12:.2f} Tops/s")

    t = time.perf_counter()
    log("[2] build")
    phase_build()
    log(f"    all built and loaded in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    chrom = simulate(num_loci=CHR21_BP // BP_PER_LOCUS, seed=38,
                     n_block_rate=0.1, name="chr21").sequence
    genome = [("chr21", chrom)] + [
        (f"bench{ci}", simulate(num_loci=30, seed=42 + ci,
                                name=f"bench{ci}").sequence)
        for ci in range(4)]
    route = simulate(num_loci=ROUTE_LOCI, seed=ROUTE_SEED, n_block_rate=0.1,
                     name="route").sequence
    log(f"    genomes simulated in {time.perf_counter() - t:.1f} s")

    cfgs = (RibbitConfig.create(), RibbitConfig.create(min_motif=4,
                                                       max_motif=37))
    log("[3] event kernels against their plain versions on the card "
        "(bit-equal)")
    cases = kernel_cases(chrom)
    err, times = phase_kernels(
        se, cases, cfgs + (RibbitConfig.create(max_motif=BIG_M),), dev, rate)

    log("[4] event extraction end to end through the port's CLI, "
        "--backend gpu")
    launches, port_s, host_s, mb, gpu_bed, host_bed, kept = phase_e2e(
        se, genome, cfgs[0], dev)
    chr21_bed = [line for line in host_bed if line.startswith("chr21\t")]
    del host_bed
    log(f"  e2e on {card}: port {port_s:.2f} s ({mb / port_s:.2f} Mbp/s), "
        f"host route {host_s:.2f} s ({mb / host_s:.2f} Mbp/s), "
        f"{os.cpu_count()} host cores")

    log("[5] SSW kernels against their plain version on the card "
        "(bit-equal)")
    ssw, pairs = phase_ssw(route, cfgs[0], dev, rate)

    log(f"[6] device-batched refinement end to end ({len(route)} bp and "
        "chr21)")
    sess, seeds, c_refine_s = kept
    try:
        ssw_cli, ssw_others = phase_batched(
            route, cfgs[0], dev, pairs,
            (sess, seeds, chrom, chr21_bed, c_refine_s))
        launches.update(ssw_cli)
    finally:
        sess.close()
    del kept, sess, seeds, chr21_bed

    log("[7] dense-mask kernel against its plain version and the event "
        "words on the card (bit-equal)")
    dense = phase_dense_kernel(
        se, sm, cases, cfgs + (RibbitConfig.create(max_motif=BIG_M),), dev,
        rate)

    log("[8] the dense path end to end (scan_events_via_masks, stitched, "
        "C replay and refinement)")
    launches["dense_masks"] = phase_dense_path(sm, genome, cfgs[0], dev,
                                               gpu_bed)
    del genome, gpu_bed

    log("[9] the int32 probe against its plain version, its SASS count, "
        "and the port's bench")
    launches["alu_probe"], probe = phase_probe_bench(dev, rate)

    log("[10] the eq_sum8 kernel against its plain version on the card "
        "(bit-equal)")
    eq_sum8 = phase_eq_sum8(sd, cases, cfgs, dev, rate)
    del cases

    log(f"[11] the Python engine end to end ({len(route)} bp, dense scan "
        "on the card)")
    launches["eq_sum8"] = phase_python_engine(sd, se, route, cfgs[0], dev)

    log("[12] the parallel routes on the card (two shards of one card, two "
        "processes)")
    par = phase_parallel(sd, se, chrom, route, pairs, cfgs[0], dev)
    del pairs

    log("[13] the device-batched voter against the C voter on the host "
        "route's call sets")
    t = time.perf_counter()
    voter = phase_voter(chrom, route, dev)
    log(f"  phase 13 in {time.perf_counter() - t:.1f} s")
    del chrom

    src = "ribbit_tpu_torch/csrc/scan_events.cu"
    replaces = {"anchor_planes": "ribbit_tpu/scan_events_pallas.py:95",
                "event_words": "ribbit_tpu/scan_events_pallas.py:187"}
    kernels = [{"name": k, "route": "cuda", "source": src,
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": err[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": times[k][2],
                "bound_by": times[k][3], "library_ms": None}
               for k in replaces]
    # one Hopper kernel serves each Pallas lineage: K9 computes K3's
    # function, K6-K8 K5's planes (tests/test_torch_align.py and
    # tests/test_torch_scan_masks.py hold them in interpret mode)
    replaces = {"ssw_forward_small": "ribbit_tpu/align_pallas_v3.py:35 and "
                                     "ribbit_tpu/align_pallas_v2.py:49",
                "ssw_forward_large": "ribbit_tpu/align_pallas.py:59"}
    kernels += [{"name": k, "route": "cuda",
                 "source": "ribbit_tpu_torch/csrc/ssw_forward.cu",
                 "replaces": replaces[k], "launches": launches[k],
                 **ssw[k], "library_ms": None,
                 "refine_launches": ssw_others[k]}
                for k in replaces]
    kernels.append({"name": "dense_masks", "route": "cuda", "source": src,
                    "replaces": "ribbit_tpu/scan_pallas_v4.py:70, "
                                "ribbit_tpu/scan_pallas_full.py:78, "
                                "ribbit_tpu/scan_pallas_v3.py:42 and "
                                "ribbit_tpu/scan_pallas_v2.py:101",
                    "launches": launches["dense_masks"], **dense,
                    "library_ms": None})
    kernels.append({"name": "alu_probe", "route": "cuda",
                    "source": "ribbit_tpu_torch/csrc/alu_probe.cu",
                    "replaces": "ribbit_tpu/bench_roofline.py:52",
                    "launches": launches["alu_probe"], **probe,
                    "library_ms": None})
    kernels.append({"name": "eq_sum8", "route": "cuda",
                    "source": "ribbit_tpu_torch/csrc/scan_dense.cu",
                    "replaces": "ribbit_tpu/scan_pallas.py:44",
                    "launches": launches["eq_sum8"], **eq_sum8,
                    "library_ms": None})
    for k in kernels:
        k["parallel_launches"] = par.get(k["name"], 0)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"voter": voter}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
