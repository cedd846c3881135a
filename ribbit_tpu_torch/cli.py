"""Command-line interface of the port, flag-compatible with ribbit_tpu.cli
(and so with the reference ribbit binary):

    python -m ribbit_tpu_torch.cli -i genome.fa -o out.bed [--backend gpu]

--backend {gpu,host,auto} replaces {auto,host,tpu}: gpu is the default,
auto an alias of it, and host runs only when named.  --device picks the
torch device of the kernels (default cuda; cpu runs their plain PyTorch
versions, for tests).  With RIBBIT_BATCHED_REFINE set, refinement runs
through refine_batched with its SSW forward passes on --device, on either
backend; with RIBBIT_PY_REFINE set, --backend host refines through the
Python engine's refinement.  The Python engine itself has no flag, as in
ribbit_tpu.cli: call process_fasta(..., engine="python").

Multi-host mode (--coordinator HOST:PORT --num-processes N --process-id
I, one command per process) runs every contig through
parallel.multihost over a gloo process group, the event kernels on
--device (every local CUDA device for the default cuda); process 0 writes
the output.  It takes the gpu route's event extraction and the C core's
refinement, and refuses --resume and --backend host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .backend import BACKENDS, require_cuda, resolve_backend
from .config import RibbitConfig
from .host import batched_refine_requested


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ribbit-tpu-torch",
        description="Tandem repeat detection on a CUDA GPU "
                    "(ribbit-compatible output)")
    from . import __version__
    p.add_argument("--version", action="version",
                   version=f"ribbit-tpu-torch {__version__}")
    p.add_argument("-i", "--input-file", required=True,
                   help="input FASTA file")
    p.add_argument("-o", "--output-file", default=None,
                   help="output BED file (default stdout)")
    p.add_argument("-m", "--min-motif-length", type=int, default=2)
    p.add_argument("-M", "--max-motif-length", type=int, default=100)
    p.add_argument("-p", "--purity", type=float, default=None,
                   help="accepted for compatibility; ignored like the "
                        "reference (hard-wired 0.85)")
    p.add_argument("-l", "--min-length", default=None,
                   help="minimum repeat length: integer or TSV "
                        "(motif_size<TAB>cutoff)")
    p.add_argument("--min-units", default=None,
                   help="minimum repeat units: integer or TSV")
    p.add_argument("--perfect-units", default=None,
                   help="minimum perfect units: integer or TSV")
    p.add_argument("--backend", choices=BACKENDS, default="gpu",
                   help="compute backend (default gpu; auto is an alias "
                        "of gpu). 'gpu' extracts events with the CUDA "
                        "kernels and fails if they cannot run; 'host' runs "
                        "the C core alone; output stays byte-identical")
    p.add_argument("--device", default="cuda",
                   help="torch device of the kernels (default cuda; cpu "
                        "runs their plain PyTorch versions)")
    p.add_argument("--stderr-output", action="store_true",
                   help="mirror the reference quirk of writing results to "
                        "stderr when no -o is given")
    p.add_argument("--workers", type=int, default=None,
                   help="parallel contigs of the host backend (default: "
                        "min(ncpu, ncontigs)); output stays byte-identical")
    p.add_argument("--timing", action="store_true",
                   help="per-phase stage timing of the C core to stderr "
                        "(implies --workers 1)")
    p.add_argument("--resume", action="store_true",
                   help="with -o: keep a per-contig completion manifest "
                        "(<out>.manifest.json) and skip already-finished "
                        "contigs on restart")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host mode: address of process 0's "
                        "rendezvous (torch.distributed, gloo); every "
                        "process gets the same value and reads the same "
                        "FASTA, and process 0 writes the output")
    p.add_argument("--num-processes", type=int, default=1,
                   help="multi-host mode: number of processes in the "
                        "group (with --coordinator)")
    p.add_argument("--process-id", type=int, default=0,
                   help="multi-host mode: this process's rank, 0 to "
                        "--num-processes - 1 (with --coordinator)")
    p.add_argument("--chunk-size", type=int, default=None, metavar="BP",
                   help="host backend: process contigs longer than 1.5x "
                        "this many bp in bounded-memory chunks, as "
                        "ribbit_tpu.cli does (the gpu backend always "
                        "extracts in 8 Mi-bp segments); output is "
                        "byte-identical")
    return p


def _maybe_int(v):
    """An integer option's value, or the string as a TSV path (a copy of
    ribbit_tpu.cli._maybe_int)."""
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        return v  # treat as TSV path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not os.path.exists(args.input_file):
        print(f"ribbit-tpu-torch: error: input file not found: "
              f"{args.input_file}", file=sys.stderr)
        return 2
    cfg = RibbitConfig.create(
        min_motif=args.min_motif_length,
        max_motif=args.max_motif_length,
        min_length=_maybe_int(args.min_length),
        min_units=_maybe_int(args.min_units),
        perfect_units=_maybe_int(args.perfect_units),
    )
    if args.coordinator is not None:
        if args.resume:
            print("ribbit-tpu-torch: --resume is not supported with "
                  "--coordinator", file=sys.stderr)
            return 2
        if args.backend == "host":
            print("ribbit-tpu-torch: error: multi-host mode runs the gpu "
                  "route; --backend host is single-process",
                  file=sys.stderr)
            return 2
        try:
            require_cuda(args.device)
        except RuntimeError as exc:
            print(f"ribbit-tpu-torch: error: {exc}", file=sys.stderr)
            return 2
        return _main_multihost(args, cfg)

    backend = resolve_backend(args.backend)
    if backend == "gpu" or batched_refine_requested():
        try:
            require_cuda(args.device)
        except RuntimeError as exc:
            print(f"ribbit-tpu-torch: error: {exc}", file=sys.stderr)
            return 2

    # the resume manifest is read BEFORE the output file is opened (mode
    # "w" would truncate the partial results being resumed)
    manifest = None
    done: dict = {}
    if args.resume and args.output_file:
        manifest = args.output_file + ".manifest.json"
        if os.path.exists(manifest) and os.path.exists(args.output_file):
            with open(manifest) as fh:
                done = json.load(fh).get("contigs", {})

    if args.output_file:
        if done:
            # a crash can land between the output flush and the manifest
            # update; truncate back to the recorded state so the resumed
            # run never duplicates a partially recorded contig
            recorded = sum(v["lines"] for v in done.values())
            with open(args.output_file) as fh:
                kept = fh.readlines()[:recorded]
            if len(kept) < recorded:
                print("ribbit-tpu-torch: output shorter than manifest; "
                      "restarting from scratch", file=sys.stderr)
                done = {}
                kept = []
            with open(args.output_file, "w") as fh:
                fh.writelines(kept)
        out = open(args.output_file, "a" if done else "w")
        if done:
            print(f"Resuming: {len(done)} contig(s) already done",
                  file=sys.stderr)
    elif args.stderr_output:
        out = sys.stderr
    else:
        out = sys.stdout

    print(f"Minimum motif:\t{cfg.min_motif}", file=sys.stderr)
    print(f"Maximum motif:\t{cfg.max_motif}", file=sys.stderr)
    print("Purity threshold: 0.85", file=sys.stderr)

    if args.timing:
        os.environ["RIBBIT_CORE_TIMING"] = "1"
        if args.workers is None:
            args.workers = 1

    from .pipeline import process_fasta_records

    t0 = time.time()
    total = 0
    try:
        for name, nbp, lines in process_fasta_records(
                args.input_file, cfg, scan_backend=backend,
                device=args.device, workers=args.workers,
                chunk_size=args.chunk_size, skip=set(done)):
            total += nbp
            if lines is None:
                continue
            print(f"Processing sequence {name}", file=sys.stderr)
            for line in lines:
                out.write(line + "\n")
            out.flush()
            if manifest:
                done[name] = {"bp": nbp, "lines": len(lines)}
                tmp = manifest + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump({"contigs": done}, fh)
                os.replace(tmp, manifest)
    finally:
        if args.output_file:
            out.close()
    elapsed = time.time() - t0
    print(f"Done: {total} bp in {elapsed:.2f}s "
          f"({total / max(elapsed, 1e-9) / 1e6:.3f} Mbp/s) [{backend}]",
          file=sys.stderr)
    return 0


def _main_multihost(args, cfg) -> int:
    """Multi-host mode: every process reads the same FASTA and works on
    each contig with the others (parallel/multihost.py); process 0 writes
    the output and the progress lines."""
    import torch.distributed as dist

    from .fasta import read_fasta
    from .parallel.multihost import (ensure_initialized,
                                     multihost_process_contig, shutdown)
    from .parallel.sharded_scan import make_mesh

    ensure_initialized(args.coordinator, args.num_processes, args.process_id)
    # the default, a bare cuda, means every local card
    devices = make_mesh(devices=None if args.device == "cuda"
                        else [args.device])
    is_main, nproc = dist.get_rank() == 0, dist.get_world_size()
    out = None
    if is_main:
        if args.output_file:
            out = open(args.output_file, "w")
        elif args.stderr_output:
            out = sys.stderr
        else:
            out = sys.stdout
        print(f"Minimum motif:\t{cfg.min_motif}", file=sys.stderr)
        print(f"Maximum motif:\t{cfg.max_motif}", file=sys.stderr)
        print("Purity threshold: 0.85", file=sys.stderr)

    t0 = time.time()
    total = 0
    try:
        for name, seq in read_fasta(args.input_file):
            if is_main:
                print(f"Processing sequence {name}", file=sys.stderr)
            total += len(seq)
            lines = multihost_process_contig(
                name, seq, cfg, chunk_size=args.chunk_size or (8 << 20),
                workers=args.workers, timing=args.timing, devices=devices)
            if is_main:
                for line in lines:
                    out.write(line + "\n")
                out.flush()
    finally:
        if is_main and args.output_file:
            out.close()
    elapsed = time.time() - t0
    shutdown()
    if is_main:
        print(f"Done: {total} bp in {elapsed:.2f}s "
              f"({total / max(elapsed, 1e-9) / 1e6:.3f} Mbp/s) "
              f"[{nproc} processes, {len(devices)} "
              "device(s) each]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
