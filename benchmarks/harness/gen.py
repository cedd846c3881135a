"""The benchmark's sequence generator: a frozen copy of the port's
ribbit_tpu_torch/sim.py (itself the recipe of upstream ribbit's
data_simulation/simulate_data.py: 80/10/10 substitution/insertion/deletion,
purity 0.85-0.95, motifs of 2-100 bp, 500-3000 bp spacers), so that no
later change to the program moves the yardstick.

simulate_length is simulate with its loop run until the sequence reaches
a stated length, then cut there: at the recipe's spacing a locus lands
every ~2,660 bp, and N blocks (5-50 bp) fall in a tenth of the spacers
when n_block_rate is 0.1.  The same seed gives the same sequence.
"""

from __future__ import annotations

import random
from collections import Counter
from dataclasses import dataclass, field

_BUFFER_SEQ = (
    "GACGTGGTCCCTACTCTCATCTTCAGAGACAAGGTTTACACTGGAAGCCTCTAGGGCAAATGGCTTTTATGATATATAGT"
    "GAAAAGGGACAGATCACTTAGACTGTCTTCAAAGGAGAACATAATTCTTCTGTTCATATGTCCTCTACTACTTAGGGTCT"
    "TTAGCAAAATCCTTTATAAGGCAAAAAACGTGCCTGTGTATCCACCTGTAGAATTTAGAGATAGTTTAAATACAGGAAGA"
    "ATAGCTTCTGCTATAGAGAAAGCCAACACATTTCCTTATAGTTACAAAATGTGTTCGGTAATATCTTCCCATTATATGTG"
    "TGTTTTATTTCAGCTTGCCTGAATGGAGAGCAAACAGCCTCAGAGGTGTCATAGGTTCTTTTAAGTCCCTTGACCATTTG"
    "GGGACCAGCTACTCTTTATTGGAAGGAAGATATTTAAGAGAATTCTTTGTTATTCCAAGGAAACTAAATAGTTGTAAAGG"
    "GACTTTTCTCCTAGGAATTAAATCTTACATAGCAACTGCATACGAATTAAAAGCAGCGTATAGATTA"
)

NUCS = "ACGT"


@dataclass
class SimulatedLocus:
    repeat_id: str
    start: int
    end: int
    motif: str
    motif_size: int
    mutations: list


@dataclass
class Simulation:
    name: str
    sequence: str
    loci: list = field(default_factory=list)

    def to_fasta(self, path: str, width: int = 80):
        with open(path, "w") as fh:
            fh.write(f">{self.name}\n")
            for i in range(0, len(self.sequence), width):
                fh.write(self.sequence[i:i + width] + "\n")

    def to_bed(self, path: str):
        with open(path, "w") as fh:
            for l in self.loci:
                muts = ";".join("|".join(m) for m in l.mutations)
                fh.write(f"{self.name}\t{l.start}\t{l.end}\t{l.repeat_id}\t"
                         f"{l.end - l.start}\t{l.motif_size}\t{l.motif}\t{muts}\n")


def _random_motif(rng: random.Random, size: int) -> str:
    """A motif that is not a repetition of a shorter unit (atomic)."""
    while True:
        m = "".join(rng.choice(NUCS) for _ in range(size))
        atomic = True
        for f in range(1, size // 2 + 1):
            if size % f == 0 and m == m[:f] * (size // f):
                atomic = False
                break
        if atomic:
            return m


def _choose_num_units(rng: random.Random, motif_size: int,
                      max_units: int = 100) -> int:
    if motif_size == 2:
        return rng.randint(6, max_units)
    if motif_size == 3:
        return rng.randint(4, max_units)
    if motif_size <= 50:
        return rng.randint(3, max_units)
    return rng.randint(2, 10)


def _mutate(rng: random.Random, repeat_seq: str, positions: list[int],
            types: list[str]):
    """mutate_repeat (simulate_data.py:27-52)."""
    info = []
    out = []
    x = 0
    for pos, typ in zip(positions, types):
        out.append(repeat_seq[x:pos])
        if typ == "D":
            info.append(["D", str(pos), repeat_seq[pos]])
            x = pos + 1
        elif typ == "S":
            ori = repeat_seq[pos]
            sub = rng.choice([c for c in NUCS if c != ori])
            out.append(sub)
            info.append(["S", str(pos), f"{ori}/{sub}"])
            x = pos + 1
        else:  # I
            ins = rng.choice(NUCS)
            out.append(ins)
            info.append(["I", str(pos), ins])
            x = pos
    out.append(repeat_seq[x:])
    return "".join(out), info


def simulate(num_loci: int = 50, seed: int = 0, min_motif: int = 2,
             max_motif: int = 100, min_purity: float = 0.85,
             max_purity: float = 0.95, motif_purity: float = 0.75,
             name: str = "sim_1", n_block_rate: float = 0.0,
             max_units: int = 100, buffer_range: tuple[int, int] = (500, 3000),
             ) -> Simulation:
    rng = random.Random(seed)
    mut_pool = ["S"] * 80 + ["I"] * 10 + ["D"] * 10

    parts: list[str] = []
    loci: list[SimulatedLocus] = []
    position = 0
    min_imp = int(100 * (1 - max_purity))
    max_imp = int(100 * (1 - min_purity))

    for ridx in range(num_loci):
        bufsize = rng.randint(*buffer_range)
        buf = (_BUFFER_SEQ * (bufsize // len(_BUFFER_SEQ) + 1))[:bufsize]
        if n_block_rate > 0 and rng.random() < n_block_rate:
            # splice an N block into the buffer to exercise N handling
            npos = rng.randint(0, max(0, bufsize - 60))
            nlen = rng.randint(5, 50)
            buf = buf[:npos] + "N" * nlen + buf[npos + nlen:]
        parts.append(buf)
        position += len(buf)

        motif_size = rng.randint(min_motif, max_motif)
        runits = _choose_num_units(rng, motif_size, max_units)
        suffix_len = int((rng.randint(0, 9) / 10) * motif_size)
        rlength = motif_size * runits + suffix_len
        if suffix_len > 0.75 * motif_size:
            runits += 1
        motif = _random_motif(rng, motif_size)
        repeat_seq = (motif * (runits + 1))[:rlength]

        impurity = rng.randint(min_imp, max_imp)
        num_mut = int(impurity / 100 * rlength)
        max_motif_mut = max(1, int(1 - motif_purity) * motif_size)
        max_mut = min(num_mut, max_motif_mut * runits)

        counter: Counter = Counter()
        mpos: list[int] = []
        mtypes: list[str] = []
        guard = 0
        while len(mpos) < max_mut and guard < 10 * rlength:
            guard += 1
            p = rng.randint(1, rlength - 1)
            if p in mpos:
                continue
            unit_idx = p // motif_size
            if counter[unit_idx] < max_motif_mut:
                mpos.append(p)
                mtypes.append(rng.choice(mut_pool))
                counter[unit_idx] += 1
        order = sorted(range(len(mpos)), key=lambda i: mpos[i])
        mpos = [mpos[i] for i in order]
        mtypes = [mtypes[i] for i in order]

        mut_seq, info = _mutate(rng, repeat_seq, mpos, mtypes)
        parts.append(mut_seq)
        loci.append(SimulatedLocus(
            repeat_id=f"R{ridx:04d}", start=position,
            end=position + len(mut_seq), motif=motif,
            motif_size=motif_size, mutations=info))
        position += len(mut_seq)

    bufsize = rng.randint(*buffer_range)
    parts.append((_BUFFER_SEQ * (bufsize // len(_BUFFER_SEQ) + 1))[:bufsize])

    return Simulation(name=name, sequence="".join(parts), loci=loci)


def simulate_length(length: int, seed: int, n_block_rate: float = 0.1,
                    min_motif: int = 2, max_motif: int = 100) -> str:
    """A sequence of exactly `length` bp: simulate's loci, one after
    another, until the sequence is that long, cut at `length`."""
    rng = random.Random(seed)
    mut_pool = ["S"] * 80 + ["I"] * 10 + ["D"] * 10
    parts: list[str] = []
    position = 0
    min_imp, max_imp = int(100 * (1 - 0.95)), int(100 * (1 - 0.85))
    while position < length:
        position += _locus(rng, parts, mut_pool, min_imp, max_imp,
                           n_block_rate, min_motif, max_motif)
    return "".join(parts)[:length]


def _locus(rng, parts, mut_pool, min_imp, max_imp, n_block_rate,
           min_motif, max_motif, motif_purity: float = 0.75,
           max_units: int = 100, buffer_range=(500, 3000)) -> int:
    """One spacer and one mutated repeat, appended to parts; simulate's
    loop body with the same draws in the same order.  Returns the bp
    added."""
    bufsize = rng.randint(*buffer_range)
    buf = (_BUFFER_SEQ * (bufsize // len(_BUFFER_SEQ) + 1))[:bufsize]
    if n_block_rate > 0 and rng.random() < n_block_rate:
        npos = rng.randint(0, max(0, bufsize - 60))
        nlen = rng.randint(5, 50)
        buf = buf[:npos] + "N" * nlen + buf[npos + nlen:]
    parts.append(buf)

    motif_size = rng.randint(min_motif, max_motif)
    runits = _choose_num_units(rng, motif_size, max_units)
    suffix_len = int((rng.randint(0, 9) / 10) * motif_size)
    rlength = motif_size * runits + suffix_len
    if suffix_len > 0.75 * motif_size:
        runits += 1
    motif = _random_motif(rng, motif_size)
    repeat_seq = (motif * (runits + 1))[:rlength]

    impurity = rng.randint(min_imp, max_imp)
    num_mut = int(impurity / 100 * rlength)
    max_motif_mut = max(1, int(1 - motif_purity) * motif_size)
    max_mut = min(num_mut, max_motif_mut * runits)

    counter: Counter = Counter()
    mpos: list[int] = []
    mtypes: list[str] = []
    guard = 0
    while len(mpos) < max_mut and guard < 10 * rlength:
        guard += 1
        p = rng.randint(1, rlength - 1)
        if p in mpos:
            continue
        unit_idx = p // motif_size
        if counter[unit_idx] < max_motif_mut:
            mpos.append(p)
            mtypes.append(rng.choice(mut_pool))
            counter[unit_idx] += 1
    order = sorted(range(len(mpos)), key=lambda i: mpos[i])
    mpos = [mpos[i] for i in order]
    mtypes = [mtypes[i] for i in order]
    mut_seq, _info = _mutate(rng, repeat_seq, mpos, mtypes)
    parts.append(mut_seq)
    return len(buf) + len(mut_seq)
