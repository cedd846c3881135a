"""Distributed layer of the port: chunked sequence parallelism over a list
of torch devices, and over processes with torch.distributed.

Counterpart of ribbit_tpu/parallel/.  Contigs split into fixed-size chunks
with halo overlap; the chunks' kernels run data-parallel over the devices
(sharded_scan.map_blocks: contiguous blocks, one thread per distinct
device) and, in multi-host mode, over processes (multihost.py, gloo
collectives); boundary-straddling events are merged deterministically on
the host, so the output is byte-identical for any topology.
"""

from .sharded_scan import make_mesh, sharded_scan_step  # noqa: F401
