"""ribbit_tpu_torch — the PyTorch and CUDA port of ribbit_tpu.

The shift-XOR event extraction (scan_events, csrc/scan_events.cu) and the
SSW forward scoring of device-batched refinement (align_kernels,
csrc/ssw_forward.cu) run as hand-written CUDA kernels for Hopper; the
order-dependent scanners, lattice replay and C-pool refinement run in the
repository's C core (csrc/ at the repo root), which native.py builds.
The host-side modules the port needs (config, encode, fasta, core,
eventstitch, align, refine, the host route) are its own copies: it imports
neither jax nor anything of ribbit_tpu.
"""

from .config import RibbitConfig
from .pipeline import process_fasta, process_fasta_records, process_sequence

__version__ = "0.1.0"

__all__ = ["RibbitConfig", "process_sequence", "process_fasta",
           "process_fasta_records", "__version__"]
