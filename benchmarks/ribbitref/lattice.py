"""Seed merge lattices.

Rule-for-rule re-implementation of the reference's order-dependent seed
insertion logic:

  - add_seed_perfect        <- addSeedToSeedPositionsPerfect
                               (parse_perfect_shiftxor.cpp:47-142)
  - add_seed_substitution   <- addSeedToSeedPositionsSubstitutions
                               (parse_substitute_shiftxor.cpp:18-388)
  - add_seed_anchored       <- addSeedToSeedPositionsAnchored
                               (parse_anchored_shiftxor.cpp:113-534)
  - merge_all_lists         <- mergeAllLists (merge_types.cpp:11-189)

Seeds are mutable 4-lists [start, end, mlen, rank].  Deliberately replicated
reference quirks are marked QUIRK with citations; they are part of the output
contract.

`bitcount(midx, start, end)` must return the popcount of shift channel `midx`
over positions [start, end) of whichever bitmap set is current for the phase
(raw XOR during the perfect/substitution scans, anchored overlay during the
anchored scan) — fasta_utils.cpp:132,136,166.

The benchmark's frozen copy of the repository's lattice.py spec.
"""

from __future__ import annotations

from typing import Callable, List

from .config import RibbitConfig, RANK_P, RANK_Q, RANK_S, RANK_C, RANK_A, RANK_N

Seed = List[int]  # [start, end, mlen, rank]
BitcountFn = Callable[[int, int, int], int]

_U32 = 0xFFFFFFFF


def _retain_nested(bitcount: BitcountFn, start: int, end: int,
                   nested_midx: int, parent_midx: int) -> bool:
    """retainNestedSeed / retainNestedSeedAnchored (identical bodies)."""
    return bitcount(nested_midx, start, end) >= bitcount(parent_midx, start, end)


def _retain_identical(bitcount: BitcountFn, start: int, end: int,
                      nested_midx: int, parent_midx: int) -> bool:
    """retainIdenticalSeeds / retainIdeniticalSeedAnchored."""
    nc = bitcount(nested_midx, start, end)
    pc = bitcount(parent_midx, start, end)
    if nc < pc:
        return False
    if nc == pc:
        return nested_midx < parent_midx
    return True


# ---------------------------------------------------------------------------
# Perfect lattice (parse_perfect_shiftxor.cpp:47-142)
# ---------------------------------------------------------------------------

def add_seed_perfect(seed_start: int, seed_end: int, motif_length: int,
                     seed_positions: List[Seed], bitcount: BitcountFn,
                     bset_size: int, cfg: RibbitConfig) -> None:
    seed_rlen = seed_end - seed_start + motif_length

    remove_seeds: List[int] = []

    for i in range(len(seed_positions) - 1, -1, -1):
        last_start, last_end, last_mlen, _rank = seed_positions[i]
        last_length = last_end - last_start
        last_rlen = last_length + last_mlen

        # list is end-sorted; stop once clear of the new seed
        if last_end < seed_start:
            break

        if last_start == seed_start and last_end == seed_end:      # identical
            if last_mlen < motif_length:
                return
            remove_seeds.append(i)

        elif last_start <= seed_start and last_end >= seed_end:    # nested
            if seed_rlen < last_mlen // 3:
                continue
            return

        elif seed_start <= last_start and seed_end >= last_end:    # parent
            if last_rlen < motif_length // 3:
                continue
            remove_seeds.append(i)

        else:                                                      # overlap
            if last_start < seed_start:
                overlap_length = last_end - seed_start + last_mlen
                merge_start, merge_end = last_start, seed_end
            else:
                overlap_length = seed_end - last_start + motif_length
                merge_start, merge_end = seed_start, last_end

            if last_mlen == motif_length:
                add_seed_perfect(merge_start, merge_end, last_mlen,
                                 seed_positions, bitcount, bset_size, cfg)
                return

            elif last_mlen < motif_length:
                if motif_length - overlap_length <= 1 and seed_rlen // motif_length < 3:
                    add_seed_perfect(merge_start, merge_end, last_mlen,
                                     seed_positions, bitcount, bset_size, cfg)
                    return
                elif seed_rlen - motif_length - overlap_length <= last_mlen:
                    return

            else:  # motif_length < last_mlen
                if last_mlen - overlap_length <= 1 and last_rlen // last_mlen < 3:
                    add_seed_perfect(merge_start, merge_end, last_mlen,
                                     seed_positions, bitcount, bset_size, cfg)
                    return
                elif last_rlen - last_mlen - overlap_length <= motif_length:
                    remove_seeds.append(i)

    # indices were collected in descending order, so deletion is stable
    for i in remove_seeds:
        del seed_positions[i]

    # clamp to the edge (the tail of the bitmap compares shifted-in zeros)
    if seed_end > bset_size - motif_length:
        seed_end = bset_size - motif_length

    seed_positions.append([seed_start, seed_end, motif_length, RANK_P])


# ---------------------------------------------------------------------------
# Substitution lattice (parse_substitute_shiftxor.cpp:18-388)
# ---------------------------------------------------------------------------

def add_seed_substitution(seed_start: int, seed_end: int, motif_length: int,
                          perfect: List[Seed], substut: List[Seed],
                          seedlen_cutoff: List[int], bitcount: BitcountFn,
                          bset_size: int, from_index: int, seed_type: int,
                          cfg: RibbitConfig) -> int:
    # advance from_index until perfect[from_index].start > seed_end
    # (literal port incl. the size-1 cap, parse_substitute_shiftxor.cpp:34-42)
    i = from_index
    while i < len(perfect):
        last_start = perfect[i][0]
        if last_start > seed_end:
            break
        elif from_index == len(perfect) - 1:
            break
        else:
            from_index += 1
        i += 1

    if seed_end - seed_start < seedlen_cutoff[motif_length - cfg.min_motif]:
        return from_index

    # merge perfect+substitution seeds into one end-descending visit order
    last_types: List[int] = []
    last_indices: List[int] = []
    mvnext_perfect = len(perfect) != 0
    mvnext_substut = len(substut) != 0
    perfect_index = from_index
    substut_index = len(substut) - 1
    perfect_end = substut_end = 0

    while mvnext_perfect or mvnext_substut:
        if not mvnext_substut:
            while mvnext_perfect:
                perfect_end = perfect[perfect_index][1]
                perfect_type = perfect[perfect_index][3]
                if perfect_end >= seed_start:
                    if perfect_type != RANK_N:
                        last_types.append(RANK_P)
                        last_indices.append(perfect_index)
                    perfect_index -= 1
                if perfect_index < 0 or perfect_end < seed_start:
                    mvnext_perfect = False
        elif not mvnext_perfect:
            while mvnext_substut:
                substut_end = substut[substut_index][1]
                substut_type = substut[substut_index][3]
                if substut_end >= seed_start:
                    if substut_type != RANK_N:
                        last_types.append(RANK_S)
                        last_indices.append(substut_index)
                    substut_index -= 1
                if substut_index < 0 or substut_end < seed_start:
                    mvnext_substut = False
        else:
            perfect_end = perfect[perfect_index][1]
            perfect_type = perfect[perfect_index][3]
            substut_end = substut[substut_index][1]
            substut_type = substut[substut_index][3]

            if substut_end > perfect_end:
                if substut_type != RANK_N:
                    last_types.append(RANK_S)
                    last_indices.append(substut_index)
                substut_index -= 1
            else:
                if perfect_type != RANK_N:
                    last_types.append(RANK_P)
                    last_indices.append(perfect_index)
                perfect_index -= 1

            if perfect_index < 0 or perfect_end < seed_start:
                mvnext_perfect = False
            if substut_index < 0 or substut_end < seed_start:
                mvnext_substut = False

    seed_rend = seed_end + motif_length
    seed_length = seed_end - seed_start
    seed_rlen = seed_length + motif_length
    seed_midx = motif_length - cfg.min_shift

    for _ in range(len(last_indices)):
        i = last_indices[_]
        if last_types[_] == RANK_P:
            last_start, last_end, last_mlen, last_type = perfect[i]
        else:
            last_start, last_end, last_mlen, last_type = substut[i]
        last_rend = last_end + last_mlen
        last_length = last_end - last_start
        last_rlen = last_rend - last_start
        last_midx = last_mlen - cfg.min_shift

        if last_end < seed_start:
            break
        if last_type == RANK_N:
            continue
        if seed_end < last_start:
            continue

        # ---- identical ----
        if seed_start == last_start and seed_end == last_end:
            if seed_type == RANK_S and last_type in (RANK_P, RANK_Q):
                return from_index
            elif seed_type == RANK_Q and last_type == RANK_P:
                return from_index
            elif seed_type == RANK_Q and last_type == RANK_S:
                substut[i] = [last_start, last_end, last_mlen, RANK_N]
            elif (seed_type == RANK_Q and last_type == RANK_Q) or \
                 (seed_type == RANK_S and last_type == RANK_S):
                if motif_length % last_mlen == 0:
                    return from_index
                elif last_mlen % motif_length == 0:
                    substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    return add_seed_substitution(seed_start, seed_end, motif_length,
                                                 perfect, substut, seedlen_cutoff,
                                                 bitcount, bset_size, from_index,
                                                 seed_type, cfg)
                else:
                    if not _retain_identical(bitcount, seed_start, seed_end,
                                             seed_midx, last_midx):
                        return from_index
                    substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    break

        # ---- nested in an existing seed ----
        elif last_start <= seed_start and seed_end <= last_end:
            if seed_type == RANK_S and last_type in (RANK_P, RANK_Q):
                return from_index
            elif seed_type == RANK_Q and last_type == RANK_P:
                return from_index
            elif (seed_type == RANK_Q and last_type in (RANK_S, RANK_Q)) or \
                 (seed_type == RANK_S and last_type == RANK_S):
                new_type = RANK_S if (seed_type == RANK_S and last_type == RANK_S) else RANK_Q
                if motif_length == last_mlen:
                    substut[i] = [last_start, last_end, motif_length, new_type]
                    return from_index
                elif motif_length % last_mlen == 0:
                    return from_index
                elif last_mlen % motif_length == 0 or last_mlen < motif_length:
                    if seed_rlen >= last_mlen - 1 or seed_rlen >= last_length - 1:
                        substut[i] = [last_start, last_end, motif_length, new_type]
                        return from_index
                    # else: add the seed separately
                else:
                    if not _retain_nested(bitcount, seed_start, seed_end,
                                          seed_midx, last_midx):
                        return from_index

        # ---- parent of an existing seed ----
        elif seed_start <= last_start and last_end <= seed_end:
            if (seed_type == RANK_S and last_type in (RANK_P, RANK_Q)) or \
               (seed_type == RANK_Q and last_type == RANK_P):
                if last_mlen % motif_length == 0:
                    if last_type == RANK_P:
                        perfect[i] = [last_start, last_end, last_mlen, RANK_N]
                    else:
                        substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    return add_seed_substitution(seed_start, seed_end, motif_length,
                                                 perfect, substut, seedlen_cutoff,
                                                 bitcount, bset_size, from_index,
                                                 RANK_Q, cfg)
                elif motif_length % last_mlen == 0 or last_mlen < motif_length:
                    if seed_length // motif_length > 3 and last_rlen >= (3 * motif_length) - 1:
                        if last_type != RANK_P:
                            substut[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_substitution(seed_start, seed_end, last_mlen,
                                                     perfect, substut, seedlen_cutoff,
                                                     bitcount, bset_size, from_index,
                                                     RANK_Q, cfg)
                    elif seed_length // motif_length <= 3 and \
                            (last_rlen >= motif_length - 1 or last_rlen >= seed_length - 1):
                        if last_type != RANK_P:
                            substut[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_substitution(seed_start, seed_end, last_mlen,
                                                     perfect, substut, seedlen_cutoff,
                                                     bitcount, bset_size, from_index,
                                                     RANK_Q, cfg)
                    # else: add the seed separately
                # else motif_length < last_mlen: retain both separately

            elif seed_type == RANK_Q and last_type == RANK_S:
                substut[i] = [last_start, last_end, last_mlen, RANK_N]
                break

            elif (seed_type == RANK_Q and last_type == RANK_Q) or \
                 (seed_type == RANK_S and last_type == RANK_S):
                if last_mlen % motif_length == 0:
                    substut[i] = [last_start, last_end, last_mlen, RANK_N]
                elif motif_length % last_mlen == 0 or motif_length > last_mlen:
                    if last_rlen >= motif_length - 1 or last_rlen >= seed_length - 1:
                        substut[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_substitution(seed_start, seed_end, last_mlen,
                                                     perfect, substut, seedlen_cutoff,
                                                     bitcount, bset_size, from_index,
                                                     seed_type, cfg)
                    else:
                        if _retain_nested(bitcount, last_start, last_end,
                                          last_midx, seed_midx):
                            continue
                        substut[i] = [last_start, last_end, last_mlen, RANK_N]
                elif last_mlen > motif_length:
                    if _retain_nested(bitcount, last_start, last_end,
                                      last_midx, seed_midx):
                        continue
                    substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    return add_seed_substitution(seed_start, seed_end, motif_length,
                                                 perfect, substut, seedlen_cutoff,
                                                 bitcount, bset_size, from_index,
                                                 seed_type, cfg)

        # ---- overlap ----
        else:
            if last_start < seed_start:
                if last_mlen <= motif_length:
                    overlap_length = (seed_end - seed_start if seed_end <= last_rend
                                      else last_rend - seed_start)
                else:
                    overlap_length = (seed_end - seed_start if seed_end <= last_end
                                      else last_end - seed_start)
                merge_start, merge_end = last_start, seed_end
            else:
                if motif_length <= last_mlen:
                    overlap_length = (last_end - last_start if last_end <= seed_rend
                                      else seed_rend - last_start)
                else:
                    overlap_length = (last_end - last_start if last_end <= seed_end
                                      else seed_end - last_start)
                merge_start, merge_end = seed_start, last_end

            if last_mlen % motif_length == 0 or last_mlen > motif_length:
                if last_length // last_mlen > 3 and overlap_length >= (3 * last_mlen) - 1:
                    if last_type == RANK_P:
                        perfect[i] = [last_start, last_end, last_mlen, RANK_N]
                    else:
                        substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    return add_seed_substitution(merge_start, merge_end, motif_length,
                                                 perfect, substut, seedlen_cutoff,
                                                 bitcount, bset_size, from_index,
                                                 RANK_Q, cfg)
                elif last_length // last_mlen <= 3 and \
                        (overlap_length >= last_mlen - 1 or overlap_length >= last_length - 1):
                    if last_type == RANK_P:
                        perfect[i] = [last_start, last_end, last_mlen, RANK_N]
                    else:
                        substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    return add_seed_substitution(merge_start, merge_end, motif_length,
                                                 perfect, substut, seedlen_cutoff,
                                                 bitcount, bset_size, from_index,
                                                 RANK_Q, cfg)

            elif motif_length % last_mlen == 0 or motif_length > last_mlen:
                if seed_length // motif_length > 3 and overlap_length >= (3 * motif_length) - 1:
                    if last_type != RANK_P:
                        substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    return add_seed_substitution(merge_start, merge_end, last_mlen,
                                                 perfect, substut, seedlen_cutoff,
                                                 bitcount, bset_size, from_index,
                                                 RANK_Q, cfg)
                elif seed_length // motif_length <= 3 and \
                        (overlap_length >= motif_length - 1 or overlap_length >= seed_length - 1):
                    if last_type != RANK_P:
                        substut[i] = [last_start, last_end, last_mlen, RANK_N]
                    return add_seed_substitution(merge_start, merge_end, last_mlen,
                                                 perfect, substut, seedlen_cutoff,
                                                 bitcount, bset_size, from_index,
                                                 RANK_Q, cfg)

    if seed_end > bset_size - motif_length:
        seed_end = bset_size - motif_length

    substut.append([seed_start, seed_end, motif_length, seed_type])
    return from_index


# ---------------------------------------------------------------------------
# 3-list merge walker (merge_types.cpp:11-189)
# ---------------------------------------------------------------------------

def merge_all_lists(perfect: List[Seed], substut: List[Seed], anchored: List[Seed],
                    from_index_perfect: int, from_index_substut: int,
                    last_types: List[int], last_indices: List[int],
                    seed_start: int) -> None:
    last_subperf_types: List[int] = []
    last_subperf_indices: List[int] = []
    perfect_start_bool = False
    substut_start_bool = False
    perfect_index = from_index_perfect
    substut_index = from_index_substut
    perfect_end = substut_end = 0

    if len(perfect) == 0:
        perfect_start_bool = True
    # QUIRK-adjacent deviation: the reference has no matching empty check for
    # the substitution list and would read out of bounds (merge_types.cpp:66);
    # that state is unreachable on real inputs, so we guard it.
    if len(substut) == 0:
        substut_start_bool = True

    while not (perfect_start_bool and substut_start_bool):
        if substut_start_bool:
            while perfect_index >= 0 or not perfect_start_bool:
                perfect_end = perfect[perfect_index][1]
                perfect_type = perfect[perfect_index][3]
                if perfect_end >= seed_start:
                    if perfect_type != RANK_N:
                        last_subperf_types.append(RANK_P)
                        last_subperf_indices.append(perfect_index)
                    perfect_index -= 1
                if perfect_index < 0 or perfect_end < seed_start:
                    perfect_start_bool = True
                    break
        elif perfect_start_bool:
            while substut_end >= 0 or not substut_start_bool:
                substut_end = substut[substut_index][1]
                substut_type = substut[substut_index][3]
                if substut_end >= seed_start:
                    if substut_type != RANK_N:
                        last_subperf_types.append(RANK_S)
                        last_subperf_indices.append(substut_index)
                    substut_index -= 1
                if substut_index < 0 or substut_end < seed_start:
                    substut_start_bool = True
                    break
        else:
            perfect_end = perfect[perfect_index][1]
            substut_end = substut[substut_index][1]
            perfect_type = perfect[perfect_index][3]
            substut_type = substut[substut_index][3]

            if substut_end > perfect_end:
                if substut_type != RANK_N:
                    last_subperf_types.append(RANK_S)
                    last_subperf_indices.append(substut_index)
                substut_index -= 1
            else:
                if perfect_type != RANK_N:
                    last_subperf_types.append(RANK_P)
                    last_subperf_indices.append(perfect_index)
                perfect_index -= 1

            if perfect_index < 0 or perfect_end < seed_start:
                perfect_start_bool = True
            if substut_index < 0 or substut_end < seed_start:
                substut_start_bool = True

    subperf_start_bool = False
    anchored_start_bool = False
    subperf_index = len(last_subperf_indices) - 1
    anchored_index = len(anchored) - 1
    subperf_end = anchored_end = 0

    if len(anchored) == 0:
        last_indices.extend(last_subperf_indices)
        last_types.extend(last_subperf_types)
    elif len(last_subperf_indices) == 0:
        while anchored_end >= 0 or not anchored_start_bool:
            anchored_end = anchored[anchored_index][1]
            anchored_type = anchored[anchored_index][3]
            if anchored_end >= seed_start:
                if anchored_type != RANK_N:
                    last_types.append(RANK_A)
                    last_indices.append(anchored_index)
                anchored_index -= 1
            if anchored_index < 0 or anchored_end < seed_start:
                break
    else:
        while not (subperf_start_bool and anchored_start_bool):
            if anchored_start_bool:
                while subperf_index >= 0 or not subperf_start_bool:
                    subperf_type = last_subperf_types[subperf_index]
                    idx = last_subperf_indices[subperf_index]
                    subperf_end = (perfect[idx][1] if subperf_type == RANK_P
                                   else substut[idx][1])
                    if subperf_end >= seed_start:
                        last_types.append(subperf_type)
                        last_indices.append(idx)
                        subperf_index -= 1
                    if subperf_index < 0 or subperf_end < seed_start:
                        subperf_start_bool = True
                        break
            elif subperf_start_bool:
                while anchored_end >= 0 or not anchored_start_bool:
                    anchored_end = anchored[anchored_index][1]
                    anchored_type = anchored[anchored_index][3]
                    if anchored_end >= seed_start:
                        if anchored_type != RANK_N:
                            last_types.append(RANK_A)
                            last_indices.append(anchored_index)
                        anchored_index -= 1
                    if anchored_index < 0 or anchored_end < seed_start:
                        anchored_start_bool = True
                        break
            else:
                subperf_type = last_subperf_types[subperf_index]
                idx = last_subperf_indices[subperf_index]
                subperf_end = (perfect[idx][1] if subperf_type == RANK_P
                               else substut[idx][1])
                anchored_end = anchored[anchored_index][1]

                if anchored_end > subperf_end:
                    last_types.append(RANK_A)
                    last_indices.append(anchored_index)
                    anchored_index -= 1
                else:
                    last_types.append(subperf_type)
                    last_indices.append(idx)
                    subperf_index -= 1

                if subperf_index < 0 or subperf_end < seed_start:
                    subperf_start_bool = True
                if anchored_index < 0 or anchored_end < seed_start:
                    anchored_start_bool = True


# ---------------------------------------------------------------------------
# Anchored lattice (parse_anchored_shiftxor.cpp:113-534)
# ---------------------------------------------------------------------------

def add_seed_anchored(seed_start: int, seed_end: int, motif_length: int,
                      perfect: List[Seed], substut: List[Seed], anchored: List[Seed],
                      seedlen_cutoffs: List[int], bitcount: BitcountFn,
                      bset_size: int, from_indices: tuple[int, int], seed_type: int,
                      cfg: RibbitConfig) -> tuple[int, int]:
    from_index_perfect, from_index_substut = from_indices

    i = from_index_perfect
    while i < len(perfect):
        last_start = perfect[i][0]
        if last_start > seed_end:
            break
        elif from_index_perfect == len(perfect) - 1:
            break
        else:
            from_index_perfect += 1
        i += 1

    i = from_index_substut
    while i < len(substut):
        last_start = substut[i][0]
        if last_start > seed_end:
            break
        elif from_index_substut == len(substut) - 1:
            break
        else:
            from_index_substut += 1
        i += 1

    if seed_end - seed_start < seedlen_cutoffs[motif_length - cfg.min_motif]:
        return (from_index_perfect, from_index_substut)

    last_types: List[int] = []
    last_indices: List[int] = []
    merge_all_lists(perfect, substut, anchored, from_index_perfect,
                    from_index_substut, last_types, last_indices, seed_start)

    seed_rend = seed_end + motif_length
    seed_length = seed_end - seed_start
    seed_rlen = seed_length + motif_length
    seed_midx = motif_length - cfg.min_shift

    # accumulators for the coverage votes
    parentof_subperf_factor: List[int] = []
    parentof_subperf_factorsizes: List[int] = []
    parentof_subperf_factortypes: List[int] = []
    parentof_subperf_multiple: List[int] = []
    parentof_subperf_multipletypes: List[int] = []
    parentof_subperf_nonfactor: List[int] = []
    parentof_subperf_nonfactorsizes: List[int] = []
    parentof_subperf_nonfactortypes: List[int] = []
    parentof_anchored_factor: List[int] = []
    parentof_anchored_nonfactor: List[int] = []
    nestedin: List[int] = []
    identical: List[int] = []

    last_start = last_end = last_rend = last_mlen = 0

    for _ in range(len(last_indices)):
        i = last_indices[_]
        if last_types[_] == RANK_P:
            last_start, last_end, last_mlen, last_type = perfect[i]
        elif last_types[_] == RANK_S:
            last_start, last_end, last_mlen, last_type = substut[i]
        else:
            last_start, last_end, last_mlen, last_type = anchored[i]
        last_rend = last_end + last_mlen

        if last_end < seed_start:
            break
        if last_type == RANK_N:
            continue
        if seed_end < last_start:
            continue

        last_length = last_end - last_start
        last_rlen = last_rend - last_start
        last_midx = last_mlen - cfg.min_shift

        # ---- identical ----
        if seed_start == last_start and seed_end == last_end:
            if seed_type == RANK_A and last_type > RANK_A:
                return (from_index_perfect, from_index_substut)
            elif seed_type == RANK_C and last_type == RANK_A:
                anchored[i] = [last_start, last_end, last_mlen, RANK_N]
            else:
                identical.append(i)

        # ---- nested in an existing seed ----
        elif last_start <= seed_start and seed_end <= last_end:
            if last_type > seed_type:
                return (from_index_perfect, from_index_substut)
            elif seed_type == RANK_C and last_type == RANK_A:
                pass
            elif (seed_type == RANK_A and last_type == RANK_A) or \
                 (seed_type == RANK_C and last_type == RANK_C):
                # QUIRK: the (motif_length != 4) / (last_mlen != 4) carve-outs
                # are in the reference (parse_anchored_shiftxor.cpp:241,246)
                if motif_length % last_mlen == 0 and motif_length != 4:
                    return (from_index_perfect, from_index_substut)
                elif last_mlen % motif_length == 0 and last_mlen != 4:
                    if seed_rlen >= last_mlen - 1 or seed_rlen >= last_length:
                        anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_anchored(last_start, last_end, motif_length,
                                                 perfect, substut, anchored,
                                                 seedlen_cutoffs, bitcount, bset_size,
                                                 from_indices, seed_type, cfg)
                    nestedin.append(i)
                    continue
                else:
                    if not _retain_nested(bitcount, seed_start, seed_end,
                                          seed_midx, last_midx):
                        return (from_index_perfect, from_index_substut)
                    nestedin.append(i)
                    continue

        # ---- parent of an existing seed ----
        elif seed_start <= last_start and last_end <= seed_end:
            if last_type > seed_type:
                if motif_length % last_mlen == 0:
                    if last_rlen >= motif_length - 2 or last_rlen >= seed_length - 2:
                        if last_type == RANK_P:
                            perfect[i] = [last_start, last_end, last_mlen, RANK_N]
                        elif last_type in (RANK_S, RANK_Q):
                            substut[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_anchored(seed_start, seed_end, last_mlen,
                                                 perfect, substut, anchored,
                                                 seedlen_cutoffs, bitcount, bset_size,
                                                 from_indices, RANK_C, cfg)
                    else:
                        parentof_subperf_factor.append(i)
                        parentof_subperf_factorsizes.append(last_mlen)
                        parentof_subperf_factortypes.append(last_type)
                elif last_mlen % motif_length == 0:
                    if last_mlen >= 4 * motif_length or last_length >= 4 * motif_length:
                        if last_type == RANK_P:
                            perfect[i] = [last_start, last_end, last_mlen, RANK_N]
                        elif last_type in (RANK_S, RANK_Q):
                            substut[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_anchored(seed_start, seed_end, motif_length,
                                                 perfect, substut, anchored,
                                                 seedlen_cutoffs, bitcount, bset_size,
                                                 from_indices, RANK_C, cfg)
                    else:
                        parentof_subperf_multiple.append(i)
                        parentof_subperf_multipletypes.append(last_type)
                elif last_mlen > motif_length:
                    if last_mlen >= 4 * motif_length or last_length >= 4 * motif_length:
                        if last_type == RANK_P:
                            perfect[i] = [last_start, last_end, last_mlen, RANK_N]
                        elif last_type in (RANK_S, RANK_Q):
                            substut[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_anchored(seed_start, seed_end, motif_length,
                                                 perfect, substut, anchored,
                                                 seedlen_cutoffs, bitcount, bset_size,
                                                 from_indices, RANK_C, cfg)
                else:
                    parentof_subperf_nonfactor.append(i)
                    parentof_subperf_nonfactorsizes.append(last_mlen)
                    parentof_subperf_nonfactortypes.append(last_type)

            elif seed_type == RANK_C and last_type == RANK_A:
                anchored[i] = [last_start, last_end, last_mlen, RANK_N]

            elif (seed_type == RANK_A and last_type == RANK_A) or \
                 (seed_type == RANK_C and last_type == RANK_C):
                if last_mlen == motif_length:
                    anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                else:
                    if not _retain_nested(bitcount, last_start, last_end,
                                          last_midx, seed_midx):
                        anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                    else:
                        if motif_length % last_mlen == 0:
                            if last_rlen >= motif_length - 2 or last_rlen >= seed_length - 2:
                                anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                                return add_seed_anchored(seed_start, seed_end, last_mlen,
                                                         perfect, substut, anchored,
                                                         seedlen_cutoffs, bitcount,
                                                         bset_size, from_indices,
                                                         seed_type, cfg)
                            parentof_anchored_factor.append(i)
                        elif last_mlen % motif_length == 0:
                            continue
                        else:
                            parentof_anchored_nonfactor.append(i)

        # ---- overlap ----
        else:
            if last_start < seed_start:
                if last_mlen <= motif_length:
                    overlap_length = (seed_end - seed_start if seed_end <= last_rend
                                      else last_rend - seed_start)
                else:
                    overlap_length = (seed_end - seed_start if seed_end <= last_end
                                      else last_end - seed_start)
                merge_start, merge_end = last_start, seed_end
            else:
                if motif_length <= last_mlen:
                    overlap_length = (last_end - last_start if last_end <= seed_rend
                                      else seed_rend - last_start)
                else:
                    overlap_length = (last_end - last_start if last_end <= seed_end
                                      else seed_end - last_start)
                merge_start, merge_end = seed_start, last_end

            if seed_type == RANK_A and last_type > RANK_C:
                if motif_length == last_mlen:
                    if overlap_length >= 4 * motif_length:
                        if last_type == RANK_P:
                            perfect[i] = [last_start, last_end, last_mlen, RANK_N]
                        elif last_type in (RANK_S, RANK_Q):
                            substut[i] = [last_start, last_end, last_mlen, RANK_N]
                        return add_seed_anchored(merge_start, merge_end, motif_length,
                                                 perfect, substut, anchored,
                                                 seedlen_cutoffs, bitcount, bset_size,
                                                 from_indices, RANK_C, cfg)
                if motif_length % last_mlen == 0 or last_mlen % motif_length == 0:
                    pass
                else:
                    if overlap_length >= motif_length - 1 or overlap_length >= seed_length - 1:
                        return (from_index_perfect, from_index_substut)

            elif (seed_type in (RANK_A, RANK_C) and last_type in (RANK_A, RANK_C)):
                if motif_length == last_mlen:
                    if last_length >= seed_length:
                        if (seed_length >= 3 * motif_length and
                                (overlap_length >= 3 * motif_length - 1 or
                                 overlap_length >= seed_length - 1)):
                            # QUIRK: `seed_type == (...) ? RANK_C : RANK_A;` in the
                            # reference is a no-op comparison, not an assignment
                            # (parse_anchored_shiftxor.cpp:402)
                            anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                            return add_seed_anchored(merge_start, merge_end, last_mlen,
                                                     perfect, substut, anchored,
                                                     seedlen_cutoffs, bitcount,
                                                     bset_size, from_indices,
                                                     seed_type, cfg)
                        elif (seed_length < 3 * motif_length and
                              (overlap_length >= motif_length - 1 or
                               overlap_length >= seed_length - 1)):
                            anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                            return add_seed_anchored(merge_start, merge_end, last_mlen,
                                                     perfect, substut, anchored,
                                                     seedlen_cutoffs, bitcount,
                                                     bset_size, from_indices,
                                                     seed_type, cfg)
                    else:
                        if (last_length >= 3 * last_mlen and
                                (overlap_length >= 3 * last_mlen - 1 or
                                 overlap_length >= last_length - 1)):
                            anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                            return add_seed_anchored(merge_start, merge_end, last_mlen,
                                                     perfect, substut, anchored,
                                                     seedlen_cutoffs, bitcount,
                                                     bset_size, from_indices,
                                                     seed_type, cfg)
                        elif (seed_length < 3 * last_mlen and
                              (overlap_length >= last_mlen - 1 or
                               overlap_length >= last_length - 1)):
                            anchored[i] = [last_start, last_end, last_mlen, RANK_N]
                            return add_seed_anchored(merge_start, merge_end, last_mlen,
                                                     perfect, substut, anchored,
                                                     seedlen_cutoffs, bitcount,
                                                     bset_size, from_indices,
                                                     seed_type, cfg)

    # ---- non-factor coverage vote (parse_anchored_shiftxor.cpp:441-468) ----
    # QUIRK: the reference indexes the seed lists with the loop counter j
    # instead of the stored seed index k, and compares against a uint32_t
    # prev_start initialised to -1; both replicated.
    if len(parentof_subperf_nonfactor) > 0:
        nonfactor_coverage = 0
        prev_start = _U32
        for j in range(len(parentof_subperf_nonfactor)):
            ktype = parentof_subperf_nonfactortypes[j]
            src = perfect if ktype == RANK_P else substut if ktype == RANK_S else None
            if src is not None:
                if j < len(src):
                    last_start, last_end, last_mlen, _t = src[j]
                else:  # reference reads out of bounds here; unreachable in practice
                    last_start = last_end = last_mlen = 0
                last_rend = last_end + last_mlen
            if (last_rend & _U32) >= prev_start:
                nonfactor_coverage += prev_start - last_start
            elif last_rend < seed_end:
                nonfactor_coverage += last_rend - last_start
            else:
                nonfactor_coverage += seed_end - last_start
            prev_start = last_start & _U32
        if nonfactor_coverage > 0.5 * seed_length:
            return (from_index_perfect, from_index_substut)

    # ---- factor coverage vote (parse_anchored_shiftxor.cpp:471-526) ----
    if len(parentof_subperf_factor) > 0:
        prev_starts = {}
        factor_coverages = {}
        factor_order = []  # mirror unordered_map iteration: collect then sort
        for factorsize in parentof_subperf_factorsizes:
            if factorsize not in prev_starts:
                factor_order.append(factorsize)
            prev_starts[factorsize] = _U32
            factor_coverages[factorsize] = 0

        for j in range(len(parentof_subperf_factor)):
            ktype = parentof_subperf_factortypes[j]
            src = perfect if ktype == RANK_P else substut if ktype == RANK_S else None
            if src is not None:
                if j < len(src):
                    last_start, last_end, last_mlen, _t = src[j]
                else:
                    last_start = last_end = last_mlen = 0
                last_rend = last_end + last_mlen
            # operator[] default-inserts 0 for keys outside the init loop
            prev_start = prev_starts.setdefault(last_mlen, 0)
            if (last_rend & _U32) >= prev_start:
                factor_coverages[last_mlen] = factor_coverages.get(last_mlen, 0) + \
                    (prev_start - last_start)
            elif last_rend < seed_end:
                factor_coverages[last_mlen] = factor_coverages.get(last_mlen, 0) + \
                    (last_rend - last_start)
            else:
                factor_coverages[last_mlen] = factor_coverages.get(last_mlen, 0) + \
                    (seed_end - last_start)
            prev_starts[last_mlen] = last_start & _U32

        for factor in sorted(factor_coverages.keys()):
            if factor_coverages[factor] >= 0.8 * seed_length:
                motif_length = factor
                seed_type = RANK_C
                # QUIRK: retag loop also uses index j and the stale
                # last_start/last_end from above (parse_anchored_shiftxor.cpp:511-522)
                for j in range(len(parentof_subperf_factor)):
                    ktype = parentof_subperf_factortypes[j]
                    if ktype == RANK_P:
                        if j < len(perfect):
                            lm = perfect[j][2]
                            if lm == factor:
                                perfect[j] = [last_start, last_end, lm, RANK_N]
                    elif ktype == RANK_S:
                        if j < len(substut):
                            lm = substut[j][2]
                            if lm == factor:
                                substut[j] = [last_start, last_end, lm, RANK_N]
                break

    if seed_end > bset_size - motif_length:
        seed_end = bset_size - motif_length
    anchored.append([seed_start, seed_end, motif_length, seed_type])
    return (from_index_perfect, from_index_substut)
