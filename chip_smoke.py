#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ribbit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. the card (nvidia-smi name and power limit), torch, CUDA and nvcc;
  2. build of the CUDA kernels from ribbit_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version on the card, bit-equal,
     on one full 8 Mi-bp segment plus halo of a simulated chromosome and
     on edge lengths, at two motif configurations; times of both at the
     segment shape (CUDA events, after a warm-up);
  4. the main path end to end through the port's CLI (--backend gpu) on a
     ~47 Mb five-contig genome made with ribbit_tpu.sim: launch counts,
     event streams against the C generation (capture_runs_host), BED
     against ribbit_tpu's host path byte for byte, and wall times.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CHR21_BP = 46_709_983          # hg38 chr21
BP_PER_LOCUS = 2660            # bench.py's chromosome recipe
EDGE_LENGTHS = (1, 7, 8, 101, 102, 103, 4097)
KERNEL_REPS = 20
PLAIN_REPS = 3


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def write_fasta(path: str, contigs) -> int:
    total = 0
    with open(path, "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + "\n")
            total += len(seq)
    return total


def phase_kernels(se, genome_seq: str, cfgs, dev):
    """Kernel vs plain version, bit-equal; times at the segment shape."""
    from ribbit_tpu.encode import encode
    from ribbit_tpu.eventstitch import HALO

    seg_len = (8 << 20) + 2 * HALO
    rng = np.random.default_rng(0)
    cases = [("segment", genome_seq[:seg_len])]
    for L in EDGE_LENGTHS:
        codes = rng.integers(0, 4, L)
        bases = np.frombuffer(b"ACGT", np.uint8)[codes]
        bases[rng.random(L) < 0.1] = ord("N")
        cases.append(("random", bases.tobytes().decode()))
    cases.append(("all-N", "N" * 5000))

    err = {"anchor_planes": 0, "event_words": 0}
    times = {}
    for cfg in cfgs:
        tag = f"m{cfg.min_motif}-M{cfg.max_motif}"
        for name, seq in cases:
            code, n_mask = encode(seq)
            c = torch.from_numpy(code.view(np.uint8)).to(dev)
            n = torch.from_numpy(n_mask.view(np.uint8)).to(dev)
            a_k = se.anchor_planes(c, cfg)
            a_p = se.anchor_planes_ref(c, cfg)
            e_a = max_abs_err(a_k, a_p)
            w_k = se.event_words(c, n, a_k, cfg)
            w_p = se.flagwords_ref(c, n, a_p, cfg)
            e_w = max_abs_err(w_k, w_p)
            torch.cuda.synchronize()
            log(f"  {tag} {name} L={len(seq)}: anchor_planes err {e_a}, "
                f"event_words err {e_w}")
            err["anchor_planes"] = max(err["anchor_planes"], e_a)
            err["event_words"] = max(err["event_words"], e_w)
            if e_a or e_w:
                raise AssertionError(f"kernel != plain version ({tag} "
                                     f"{name}: {e_a}, {e_w})")
            if name == "segment" and cfg is cfgs[0]:
                times["anchor_planes"] = (
                    cuda_ms(lambda: se.anchor_planes(c, cfg), KERNEL_REPS),
                    cuda_ms(lambda: se.anchor_planes_ref(c, cfg),
                            PLAIN_REPS))
                times["event_words"] = (
                    cuda_ms(lambda: se.event_words(c, n, a_k, cfg),
                            KERNEL_REPS),
                    cuda_ms(lambda: se.flagwords_ref(c, n, a_k, cfg),
                            PLAIN_REPS))
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
            del a_k, a_p, w_k, w_p
    for k, (ms, pms) in times.items():
        log(f"  {k} at the segment shape: kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms ({pms / ms:.1f}x)")
    return err, times


def phase_e2e(se, genome, cfg, dev):
    """The port's CLI with --backend gpu against the C generation and the
    host path."""
    from ribbit_tpu.core import CoreSession
    from ribbit_tpu.encode import encode
    from ribbit_tpu.eventstitch import (capture_runs_host,
                                        scan_events_segmented, segment_bounds)
    from ribbit_tpu.pipeline import process_fasta as host_process_fasta
    from ribbit_tpu_torch.cli import main as cli_main
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
        host_lines = host_process_fasta(fa, cfg, scan_backend="host")
        host_s = time.perf_counter() - t
        if port_lines != host_lines:
            diff = next((i for i, (a, b) in enumerate(
                zip(port_lines, host_lines)) if a != b),
                min(len(port_lines), len(host_lines)))
            raise AssertionError(
                f"BED differs from the host path: {len(port_lines)} vs "
                f"{len(host_lines)} lines, first difference at line {diff}")
        log(f"  BED identical to ribbit_tpu's host path, in order: "
            f"{len(port_lines)} lines")

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
        finally:
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
    return launches, port_s, host_s, mb


def spec_runs(code, n_mask, cfg, stream: int, ch: int):
    """(starts, ends) of one channel of one stream (0 perfect, 1 q7, 2 q6)
    by the numpy spec, ribbit_tpu.scan_host."""
    from types import SimpleNamespace

    from ribbit_tpu import scan_host

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import ribbit_tpu_torch.scan_events as se
    from ribbit_tpu.config import RibbitConfig
    from ribbit_tpu.core import get_core_lib
    from ribbit_tpu.sim import simulate
    from ribbit_tpu_torch import cuda_build

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}, python "
        f"{sys.version.split()[0]}")

    t = time.perf_counter()
    cuda_build.load("scan_events")
    log(f"[2] built and loaded ribbit_tpu_torch/csrc/scan_events.cu in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    if get_core_lib() is None:
        raise RuntimeError("the shared C core (csrc/) did not build")
    log(f"    built and loaded the shared C core in "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    chrom = simulate(num_loci=CHR21_BP // BP_PER_LOCUS, seed=38,
                     n_block_rate=0.1, name="chr21").sequence
    genome = [("chr21", chrom)] + [
        (f"bench{ci}", simulate(num_loci=30, seed=42 + ci,
                                name=f"bench{ci}").sequence)
        for ci in range(4)]
    log(f"    genome simulated in {time.perf_counter() - t:.1f} s")

    cfgs = (RibbitConfig.create(), RibbitConfig.create(min_motif=4,
                                                       max_motif=37))
    log("[3] kernels against their plain versions on the card (bit-equal)")
    err, times = phase_kernels(se, chrom, cfgs, dev)

    log("[4] end to end through the port's CLI, --backend gpu")
    launches, port_s, host_s, mb = phase_e2e(se, genome, cfgs[0], dev)
    log(f"  e2e on {card}: port {port_s:.2f} s ({mb / port_s:.2f} Mbp/s), "
        f"host path {host_s:.2f} s ({mb / host_s:.2f} Mbp/s), "
        f"{os.cpu_count()} host cores")

    src = "ribbit_tpu_torch/csrc/scan_events.cu"
    replaces = {"anchor_planes": "ribbit_tpu/scan_events_pallas.py:95",
                "event_words": "ribbit_tpu/scan_events_pallas.py:187"}
    kernels = [{"name": k, "route": "cuda", "source": src,
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": err[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in replaces]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
