"""FASTA streaming reader.

Matches the reference reader semantics (ribbit.cpp:269-280): records are
accumulated line-by-line; the sequence name is the first whitespace-delimited
word after '>'.  Also parses .fai indexes (fasta_utils.cpp:22-42) for the
chunked/distributed path.

The port's copy of ribbit_tpu/fasta.py, which it may not import.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yields (name, sequence) per record, in file order."""
    name = None
    parts: list[str] = []
    # latin-1 preserves arbitrary bytes 1:1 (downstream treats non-ACGT as N)
    with open(path, encoding="latin-1") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                sp = line.find(" ")
                name = line[1:sp if sp != -1 else len(line)]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        yield name, "".join(parts)


def read_fai(path: str) -> dict[str, int]:
    """chrom -> length from a samtools-style .fai index."""
    out: dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 2:
                out[cols[0]] = int(cols[1])
    return out


def write_fasta(path: str, records: list[tuple[str, str]], width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
