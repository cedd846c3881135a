"""Hermetic tandem-repeat simulator.

Re-creation of data_simulation/simulate_data.py with no external data
dependencies: the reference script needs `proportions.tsv` and
`HG38_2-100_motifs_d2d.tsv` (simulate_data.py:85-98) which are not in the
repo, so we synthesize the motif pool from a seeded RNG instead.  Mutation
model matches the reference: 80% substitution / 10% insertion / 10% deletion
(simulate_data.py:10), purity band [min_purity, max_purity]
(simulate_data.py:60-61, 113-114), buffer spacers of 500-3000 bp.

The port's copy of ribbit_tpu/sim.py, which it may not import.
"""

from __future__ import annotations

import random
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

        from collections import Counter
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


def _main(argv=None) -> int:
    """CLI mirroring data_simulation/simulate_data.py's flags
    (simulate_data.py:55-73); writes sim_<prefix>.fa + ground-truth
    sim_<prefix>.bed."""
    import argparse

    p = argparse.ArgumentParser(description="Tandem Repeat Simulator")
    p.add_argument("-l", "--num-locations", type=int, default=1000)
    p.add_argument("-o", "--out-prefix", type=str, default="")
    p.add_argument("--min-purity", type=float, default=0.85)
    p.add_argument("--max-purity", type=float, default=0.95)
    p.add_argument("--motif-purity", type=float, default=0.75)
    p.add_argument("-m", "--min-motif-size", type=int, default=2)
    p.add_argument("-M", "--max-motif-size", type=int, default=100)
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed (ours; the reference is unseeded)")
    args = p.parse_args(argv)

    if not args.out_prefix:
        rng = random.Random(args.seed)
        args.out_prefix = ("%06x" % rng.randint(0, 0xFFFFFFFFFF)).upper()
    print(f"File prefix: {args.out_prefix}")

    sim = simulate(num_loci=args.num_locations,
                   seed=args.seed if args.seed is not None
                   else random.randrange(1 << 30),
                   min_motif=args.min_motif_size,
                   max_motif=args.max_motif_size,
                   min_purity=args.min_purity,
                   max_purity=args.max_purity,
                   motif_purity=args.motif_purity,
                   name=f"{args.out_prefix}_1")
    sim.to_fasta(f"sim_{args.out_prefix}.fa")
    sim.to_bed(f"sim_{args.out_prefix}.bed")
    print(f"wrote sim_{args.out_prefix}.fa ({len(sim.sequence)} bp, "
          f"{len(sim.loci)} loci) + sim_{args.out_prefix}.bed")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
