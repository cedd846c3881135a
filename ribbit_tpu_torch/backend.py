"""Backend selection: the card unless the host is asked for by name.

Counterpart of ribbit_tpu/backend.py without its link probe.  'gpu' is
the default; 'auto' stays as a flag-compatible alias of it and says so on
stderr.  Neither falls back to the host: without CUDA a gpu run on
--device cuda fails loudly (cli.py checks before any output is written).
'host' runs the C core alone, and only when named.
"""

from __future__ import annotations

import sys

import torch

BACKENDS = ("gpu", "host", "auto")


def resolve_backend(requested: str = "gpu") -> str:
    """'host' or 'gpu' for a requested backend."""
    if requested not in BACKENDS:
        raise ValueError(f"unknown backend {requested!r}")
    if requested != "auto":
        return requested
    print("ribbit-tpu-torch: backend auto -> gpu (auto is an alias of gpu; "
          "name --backend host for the C core alone)", file=sys.stderr)
    return "gpu"


def require_cuda(device) -> None:
    """Raise if `device` is a CUDA device and CUDA is unavailable."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but "
                           "torch.cuda.is_available() is False")
