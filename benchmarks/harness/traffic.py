"""The one general generator: a cell's inputs from its configuration file,
its traffic file and the run's seed.

A configuration lists the records of one genome copy ("records": name and
length each, in published order) and the generator's recipe: the share
of spacers that hold an N block ("n_block_rate") and, optionally, a
"recipe" object ("motif_bp": [lo, hi], the range of planted motif
sizes, 2-100 bp when left out); an unknown key or value raises as the
run is planned.  A traffic file says how the records are laid out:

  layout     "one_fasta": every record in one multi-record FASTA, one
             call of the entry; "per_record": one single-record FASTA a
             job, the jobs run one after another (a closed loop, one
             client)
  warmup     the first record: {"record": name} takes that record of the
             configuration, {"length": n} a record of n bp
  pass_bp    genome copies are added, whole, until the records after the
             warm-up hold this many bp
  check      which records the correctness check samples ("records" of
             them, drawn from the delivered indices "from"), and the
             prefix ("prefix_bp") of each that the plain reference runs

Every record has a seed of its own, worked out from the run's seed and
its place, so the same seed gives the same files, and each copy of the
genome differs.  Files are written by worker processes, each record at
its own offset, so the driving process never holds the sequences.
"""

from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import os
import pathlib
from concurrent.futures import ProcessPoolExecutor

from . import gen

WIDTH = 80          # FASTA line width


@dataclasses.dataclass
class Record:
    name: str
    length: int
    seed: int
    path: str = ""          # the file that holds it
    offset: int = 0         # its byte offset there


def record_seed(seed: int, copy: int, index: int) -> int:
    h = hashlib.blake2b(f"{seed}:{copy}:{index}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def recipe(config: dict) -> dict:
    """gen.simulate_length's keywords from the configuration's "recipe"
    object, checked: a misspelt key must not fall back to a default."""
    given = config.get("recipe", {})
    unknown = sorted(set(given) - {"motif_bp"})
    if unknown:
        raise ValueError(f"unknown recipe key(s) {unknown}; known: "
                         "['motif_bp']")
    if "motif_bp" not in given:
        return {}
    lo, hi = given["motif_bp"]
    if not (isinstance(lo, int) and isinstance(hi, int) and 2 <= lo <= hi):
        raise ValueError(f"recipe motif_bp {given['motif_bp']!r}: two whole "
                         "numbers, 2 <= lo <= hi")
    return {"min_motif": lo, "max_motif": hi}


def plan(config: dict, traffic: dict, seed: int) -> list:
    """The records of a run in delivery order; the warm-up record first."""
    recipe(config)
    recs = config["records"]
    w = traffic["warmup"]
    if "record" in w:
        (length,) = [r["length"] for r in recs if r["name"] == w["record"]]
        warm = Record(f"{w['record']}_warmup", length, record_seed(seed, 0, 0))
    else:
        warm = Record("warmup", int(w["length"]), record_seed(seed, 0, 0))
    out = [warm]
    total = 0
    copy = 0
    while total < traffic["pass_bp"]:
        copy += 1
        for i, r in enumerate(recs):
            out.append(Record(f"{r['name']}_{copy}", int(r["length"]),
                              record_seed(seed, copy, i + 1)))
            total += int(r["length"])
    return out


def fasta_bytes(name: str, length: int) -> int:
    return len(name) + 2 + length + (length + WIDTH - 1) // WIDTH


def layout(records: list, traffic: dict, directory: pathlib.Path) -> list:
    """Assign each record its file and offset; returns the files to run,
    in order (one, or one a job)."""
    if traffic["layout"] == "one_fasta":
        path = str(directory / "genome.fa")
        off = 0
        for r in records:
            r.path, r.offset = path, off
            off += fasta_bytes(r.name, r.length)
        with open(path, "wb") as fh:
            fh.truncate(off)
        return [path]
    if traffic["layout"] != "per_record":
        raise ValueError(f"unknown layout {traffic['layout']!r}")
    for k, r in enumerate(records):
        r.path, r.offset = str(directory / f"job_{k:05d}.fa"), 0
        with open(r.path, "wb") as fh:
            fh.truncate(fasta_bytes(r.name, r.length))
    return [r.path for r in records]


def sequence(r: Record, config: dict) -> str:
    """The record's sequence: what the writer puts in its file and what
    the check regenerates."""
    return gen.simulate_length(r.length, r.seed, float(config["n_block_rate"]),
                               **recipe(config))


def _write(r: Record, config: dict) -> None:
    seq = sequence(r, config)
    lines = [f">{r.name}"]
    lines += [seq[i:i + WIDTH] for i in range(0, len(seq), WIDTH)]
    data = ("\n".join(lines) + "\n").encode("ascii")
    with open(r.path, "r+b") as fh:
        fh.seek(r.offset)
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())      # written back now, not in the window


def start_writing(records: list, config: dict, workers: int = 0):
    """Write every record in spawned worker processes; returns (pool,
    futures): read every future, then shut the pool down."""
    workers = workers or min(8, os.cpu_count() or 1)
    pool = ProcessPoolExecutor(workers,
                               mp_context=multiprocessing.get_context("spawn"))
    # longest first, so that the pool ends together
    order = sorted(records, key=lambda r: -r.length)
    return pool, [pool.submit(_write, r, config) for r in order]
