"""Device-split refinement scoring.

Counterpart of ribbit_tpu/parallel/sharded_refine.py, whose module imports
jax.  The device-batched refinement (refine_batched.py) scores each
alignment round as one batch of (read, ref) pairs.  Here the pairs within
fits() split into contiguous blocks over a list of devices; each device
runs the SSW forward kernel for such pairs (K3, ssw_forward_small) on its
block, with no exchange between devices, and the results concatenate in
input order.  Oversized pairs (K4, ssw_forward_large) stay on the first
device, as the JAX package keeps them single-device: they are rare and
latency-bound.

The split forward is bit-identical to the single-device batch, so
refine_batched's output, already exactly the sequential path's, is
unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .. import align_kernels
from .sharded_scan import make_mesh, map_blocks


def batch_forward_sharded(reads: list, refs: list,
                          terminates: Optional[list] = None,
                          devices: Optional[Sequence] = None,
                          n_devices: Optional[int] = None):
    """(score, end_ref, end_read, first_hit) [n] of pairs within fits()
    (1-byte codes 0-4; terminate targets None or -1 for forward mode),
    K3 on each device's contiguous block of pairs: the contract of
    align_pallas_v3.batch_forward."""
    def block(device, r):
        terms = (None if terminates is None
                 else [terminates[i] for i in r])
        return align_kernels.forward(
            align_kernels.ssw_forward_small, [reads[i] for i in r],
            [refs[i] for i in r], terms, device)

    outs = map_blocks(make_mesh(n_devices, devices), len(reads), block)
    if not outs:
        return tuple(np.zeros(0, np.int32) for _ in range(4))
    return tuple(np.concatenate([o[f] for o in outs]) for f in range(4))


def refine_batched_sharded(seeds, sequence: str, sequence_id: str,
                           code, n_mask, sess, cfg,
                           devices: Optional[Sequence] = None,
                           n_devices: Optional[int] = None) -> List[str]:
    """refine_batched with each round's fits() pairs split over the
    devices (make_mesh(n_devices, devices)) and the oversized pairs on the
    first.  Output is byte-identical to the sequential refinement."""
    from ..refine_batched import refine_batched

    return refine_batched(seeds, sequence, sequence_id, code, n_mask, sess,
                          cfg, device=make_mesh(n_devices, devices))
