"""Import boundary and build of the PyTorch port: importing it (and running
its pipeline on the CPU) loads no jax and none of the JAX package's device
modules; the CUDA build is keyed by source hash and raises with nvcc's
output when nvcc fails."""

import os
import stat
import subprocess
import sys

import pytest
import torch

from ribbit_tpu_torch import cuda_build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import ribbit_tpu_torch, ribbit_tpu_torch.cli, ribbit_tpu_torch.pipeline
import ribbit_tpu_torch.scan_events, ribbit_tpu_torch.backend
import ribbit_tpu_torch.cuda_build
bad = [m for m in ("jax", "ribbit_tpu.scan_events_pallas",
                   "ribbit_tpu.scan_pallas_v2", "ribbit_tpu.scan_events_tpu")
       if m in sys.modules]
assert not bad, ("after import", bad)
from ribbit_tpu_torch import RibbitConfig, process_fasta
lines = process_fasta(sys.argv[1], RibbitConfig.create(), device="cpu")
assert lines, "no output"
bad = [m for m in ("jax", "ribbit_tpu.scan_events_pallas",
                   "ribbit_tpu.scan_pallas_v2") if m in sys.modules]
assert not bad, ("after a pipeline run", bad)
print("NO_JAX_OK")
"""


def test_port_never_imports_jax(golden_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _PROBE,
                        str(golden_dir / "g3.fa")], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_cuda_build_is_hash_keyed(tmp_path, monkeypatch):
    """A build lands in build/cuda/<stem>_<sha16>.so and is reused."""
    log = tmp_path / "calls"
    # the fake compiler writes its -o target (the argument after -o)
    nvcc = _fake_nvcc(tmp_path / "nvcc",
                      f'echo x >> {log}\nwhile [ "$1" != "-o" ]; do shift; '
                      'done\necho so > "$2"\n')
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build" / "cuda")
    out = cuda_build.build("scan_events")
    assert out.parent == tmp_path / "build" / "cuda"
    assert out.name.startswith("scan_events_") and len(out.stem) == 12 + 16
    assert cuda_build.build("scan_events") == out
    assert log.read_text().count("x") == 1
    assert list(out.parent.iterdir()) == [out]


def test_cuda_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path / "nvcc",
                      'echo "error: no such intrinsic" >&2\nexit 2\n')
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        cuda_build.build("scan_events")
    assert not any((tmp_path / "build").iterdir())


def test_kernel_sources_ship_and_build_dir_is_ignored():
    assert (cuda_build.CSRC / "scan_events.cu").exists()
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()
    assert cuda_build.BUILD == cuda_build.CSRC.parent.parent / "build" / \
        "cuda"
