"""Run configuration for the ribbit-tpu tandem-repeat engine.

Mirrors the reference CLI semantics (ribbit.cpp:68-243):
  - motif range [min_motif, max_motif], default [2, 100]
  - shift range [max(1, min_motif-2), max_motif+2]
  - minimum-length / minimum-units / perfect-units thresholds, either a single
    integer for all motif sizes or a per-motif-size TSV file (dual-type args,
    ribbit.cpp:25-64)
  - factor-motif threshold propagation (ribbit.cpp:219-235)
  - purity threshold is hard-wired to 0.85: the reference declares -p but never
    reads it (ribbit.cpp:92, no handler in 114-176).

The benchmark's frozen copy of the repository's config.py spec.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np

# Seed rank constants (global_variables.cpp:29-35)
RANK_P = 5
RANK_Q = 4
RANK_S = 3
RANK_F = 2
RANK_C = 1
RANK_A = 0
RANK_N = -1

# Hard-wired scan parameters (ribbit.cpp:191, fasta_utils.cpp:165)
WINDOW_LENGTH = 8
WINDOW_BITCOUNT_SUBSTITUTION = 7
WINDOW_BITCOUNT_ANCHORED = 6
ANCHOR_SIZE = 3
CONTINUOUS_ONES_THRESHOLD = 3

# Hard-wired purity threshold, kept in float32 to mirror the C++ `float`
# (global_variables.cpp:44).
PURITY_THRESHOLD = np.float32(0.85)


def _parse_dualtype(value: Union[int, str, Dict[int, int]],
                    min_motif: int, max_motif: int) -> Dict[int, int]:
    """Integer → same cutoff for all motif lengths; str → TSV file path with
    (motif_size, cutoff) rows; dict passed through (ribbit.cpp:25-64)."""
    if isinstance(value, dict):
        return dict(value)
    if isinstance(value, int):
        return {m: value for m in range(min_motif, max_motif + 1)}
    out: Dict[int, int] = {}
    try:
        fh = open(value)
    except OSError as e:
        # Deliberate divergence: the reference checks fail() BEFORE open()
        # (ribbit.cpp:48-53), so an unopenable file is silently treated as
        # empty and every cutoff becomes 0.  A hard error is safer.
        raise SystemExit(f"ERROR: cannot open {value!r} for a per-motif "
                         f"threshold file: {e.strerror}")
    with fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            pos = line.find("\t")
            if pos == -1:
                # reference quirk (ribbit.cpp:55-58): with no tab, npos+1
                # wraps to 0, so both substr calls yield the whole line and
                # the key doubles as the value.
                out[int(line)] = int(line)
            else:
                out[int(line[:pos])] = int(line[pos + 1:])
    return out


@dataclasses.dataclass
class RibbitConfig:
    min_motif: int = 2
    max_motif: int = 100

    # thresholds; populated by resolve()
    minimum_length: Dict[int, int] = dataclasses.field(default_factory=dict)
    perfect_units: Dict[int, int] = dataclasses.field(default_factory=dict)

    # derived shift range
    min_shift: int = 1
    max_shift: int = 102
    nshifts: int = 102
    nmotifs: int = 99

    @classmethod
    def create(cls,
               min_motif: int = 2,
               max_motif: int = 100,
               min_length: Optional[Union[int, str, Dict[int, int]]] = None,
               min_units: Optional[Union[int, str, Dict[int, int]]] = None,
               perfect_units: Optional[Union[int, str, Dict[int, int]]] = None,
               ) -> "RibbitConfig":
        cfg = cls(min_motif=min_motif, max_motif=max_motif)

        # --- minimum length (ribbit.cpp:143-160, 210-215) ---
        if min_length is not None:
            cfg.minimum_length = _parse_dualtype(min_length, min_motif, max_motif)
        elif min_units is not None:
            units = _parse_dualtype(min_units, min_motif, max_motif)
            cfg.minimum_length = {m: m * u for m, u in units.items()}
        else:
            default_minimum_length = 12
            cfg.minimum_length = {
                m: (2 * m if default_minimum_length < 2 * m else default_minimum_length)
                for m in range(min_motif, max_motif + 1)
            }

        # --- perfect units (ribbit.cpp:163-174) ---
        if perfect_units is not None:
            cfg.perfect_units = _parse_dualtype(perfect_units, min_motif, max_motif)
        else:
            pu = {}
            for m in range(1, max_motif + 1):
                pu[m] = {1: 8, 2: 4, 3: 3}.get(m, 2)
            cfg.perfect_units = pu

        # --- factor-motif propagation (ribbit.cpp:219-235) ---
        # The reference reads the source threshold with unordered_map
        # operator[], which default-inserts 0 for a motif size absent from a
        # sparse TSV file; the inserted key then suppresses later propagation
        # to that size.  _read_ins mirrors that exactly.
        def _read_ins(d: Dict[int, int], k: int) -> int:
            if k not in d:
                d[k] = 0
            return d[k]

        for m in range(min_motif, max_motif + 1):
            factors = [f for f in range(1, m // 2 + 1) if m % f == 0]
            for f in factors:
                if f not in cfg.minimum_length:
                    cfg.minimum_length[f] = _read_ins(cfg.minimum_length, m)
                if f not in cfg.perfect_units:
                    cfg.perfect_units[f] = _read_ins(cfg.perfect_units, m) * (m // f)

        # --- shift range (ribbit.cpp:240-243) ---
        cfg.nmotifs = max_motif - min_motif + 1
        cfg.min_shift = min_motif - 2 if min_motif > 2 else 1
        cfg.max_shift = max_motif + 2
        cfg.nshifts = cfg.max_shift - cfg.min_shift + 1
        return cfg

    # unordered_map operator[] defaults missing keys to 0; mirror with .get
    def min_length(self, m: int) -> int:
        return self.minimum_length.get(m, 0)

    def n_perfect_units(self, m: int) -> int:
        return self.perfect_units.get(m, 0)

    def motif_channel(self, m: int) -> int:
        """Index of motif length m's shift-XOR channel."""
        return m - self.min_shift
