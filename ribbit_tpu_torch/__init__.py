"""ribbit_tpu_torch — the PyTorch and CUDA port of ribbit_tpu.

The shift-XOR event extraction runs as hand-written CUDA kernels for
Hopper (scan_events, csrc/scan_events.cu); the order-dependent scanners,
lattice replay and refinement run in the shared C core of ribbit_tpu,
whose host-side modules (config, encode, fasta, core, eventstitch, the
host pipeline) this package imports rather than copies.  It never imports
jax.
"""

from ribbit_tpu.config import RibbitConfig

from .pipeline import process_fasta, process_fasta_records, process_sequence

__version__ = "0.1.0"

__all__ = ["RibbitConfig", "process_sequence", "process_fasta",
           "process_fasta_records", "__version__"]
