"""Backend selection for --backend auto (the default).

Counterpart of ribbit_tpu/backend.py without its link probe: a CUDA card
sits on the host's own PCIe or NVLink, so whether it is there is the whole
question.  'auto' resolves to 'gpu' when torch.cuda.is_available(), else
to 'host', and says which on stderr.  An explicit choice passes through
unchanged: an explicit 'gpu' on a machine without CUDA fails later,
loudly, rather than running on the host.
"""

from __future__ import annotations

import sys

import torch

BACKENDS = ("auto", "host", "gpu")


def resolve_backend(requested: str = "auto") -> str:
    """'host' or 'gpu' for a requested backend."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend {requested!r}")
    if requested != "auto":
        return requested
    if torch.cuda.is_available():
        choice, why = "gpu", f"CUDA device {torch.cuda.get_device_name(0)}"
    else:
        choice, why = "host", "torch.cuda.is_available() is False"
    print(f"ribbit-tpu-torch: backend auto -> {choice} ({why})",
          file=sys.stderr)
    return choice
