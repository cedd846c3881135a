"""Import boundary, copies and build of the PyTorch port: no module of the
port (nor chip_smoke.py) imports jax or anything of ribbit_tpu, and none is
loaded after its CLI runs; its copies of the JAX package's host modules
give the same results (the host route byte for byte, the simulator, the
config); the CUDA build is keyed by source hash and raises with nvcc's
output when nvcc fails; the C core's build raises too."""

import ast
import dataclasses
import os
import pathlib
import stat
import subprocess
import sys

import pytest
import torch

from ribbit_tpu import pipeline as jax_pipeline
from ribbit_tpu import sim as jax_sim
from ribbit_tpu.config import RibbitConfig as JaxConfig

from ribbit_tpu_torch import cuda_build, native, sim
from ribbit_tpu_torch.cli import main as cli_main
from ribbit_tpu_torch.config import RibbitConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import os, sys
import ribbit_tpu_torch, ribbit_tpu_torch.cli, ribbit_tpu_torch.pipeline
import ribbit_tpu_torch.scan_events, ribbit_tpu_torch.backend
import ribbit_tpu_torch.cuda_build, ribbit_tpu_torch.refine_batched
import ribbit_tpu_torch.scan_dense, ribbit_tpu_torch.events
import ribbit_tpu_torch.lattice, ribbit_tpu_torch.parallel
import ribbit_tpu_torch.parallel.distributed
import ribbit_tpu_torch.parallel.multihost
import ribbit_tpu_torch.parallel.sharded_refine
from ribbit_tpu_torch.cli import main
from ribbit_tpu_torch.config import RibbitConfig

def foreign():
    return [m for m in sys.modules if m in ("jax", "ribbit_tpu")
            or m.startswith(("jax.", "ribbit_tpu."))]

assert not foreign(), ("after import", foreign())
fa = sys.argv[1]
for env, argv in (({}, ["--backend", "gpu", "--device", "cpu"]),
                  ({"RIBBIT_BATCHED_REFINE": "1"},
                   ["--backend", "gpu", "--device", "cpu"]),
                  ({}, ["--backend", "host"])):
    os.environ.update(env)
    assert main(argv + ["-i", fa, "-o", os.devnull]) == 0, argv
    os.environ.pop("RIBBIT_BATCHED_REFINE", None)
    assert not foreign(), (argv, env, foreign())
assert ribbit_tpu_torch.pipeline.process_fasta(
    fa, RibbitConfig.create(), device="cpu", engine="python")
assert not foreign(), ("python engine", foreign())
print("NO_JAX_OK")
"""


def test_port_never_imports_jax(golden_dir):
    """Neither jax nor any module of ribbit_tpu is loaded by importing the
    port or by its CLI on the gpu route (--device cpu), the batched route
    and the host route, nor by the Python engine over the dense scan."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    # torch threads capped as in this process: the plain SSW version runs
    # thousands of small ops, and a full core count of spinning threads on
    # a loaded machine makes each of them slow
    env["OMP_NUM_THREADS"] = "2"
    r = subprocess.run([sys.executable, "-c", _PROBE,
                        str(golden_dir / "g3.fa")], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


def _imports(path):
    """Top-level names of every module an import statement in `path`
    names (relative imports resolve inside the package)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_sources_import_nothing_of_jax_package():
    root = pathlib.Path(REPO)
    files = sorted((root / "ribbit_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ribbit_tpu"), (f, name)


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


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    """The port's C-core loader raises (never returns None) and leaves no
    half-written library behind."""
    bad = tmp_path / "bad.c"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "_BUILD", tmp_path / "native")
    with pytest.raises(RuntimeError, match="did not build"):
        native._compile([bad])
    assert not any((tmp_path / "native").iterdir())


def _two_contig_fasta(tmp_path):
    fa = tmp_path / "two.fa"
    parts = [jax_sim.simulate(num_loci=3, seed=80 + k, name=f"s{k}")
             for k in range(2)]
    fa.write_text("".join(f">{p.name}\n{p.sequence}\n" for p in parts))
    return fa


@pytest.mark.parametrize("chunk", [None, 4000], ids=["whole", "chunk4000"])
@pytest.mark.parametrize("name", ["g1", "g2", "g3", "sim2"])
def test_host_route_matches_jax_package(golden_dir, tmp_path, name, chunk):
    """The port's --backend host equals ribbit_tpu's host route."""
    fa = (_two_contig_fasta(tmp_path) if name == "sim2"
          else golden_dir / f"{name}.fa")
    out = tmp_path / "out.bed"
    argv = ["--backend", "host", "-i", str(fa), "-o", str(out)]
    if chunk:
        argv += ["--chunk-size", str(chunk)]
    assert cli_main(argv) == 0
    want = jax_pipeline.process_fasta(str(fa), JaxConfig.create(),
                                      scan_backend="host", chunk_size=chunk)
    assert want and out.read_text().splitlines() == want


@pytest.mark.parametrize("seed", [7, 38, 90])
def test_sim_matches_jax_package(seed):
    kw = dict(num_loci=4, seed=seed, n_block_rate=0.3, name="x")
    a, b = sim.simulate(**kw), jax_sim.simulate(**kw)
    assert a.sequence == b.sequence
    assert [dataclasses.astuple(x) for x in a.loci] == \
        [dataclasses.astuple(x) for x in b.loci]


@pytest.mark.parametrize("case", ["default", "m4-M37", "tsv"])
def test_config_matches_jax_package(tmp_path, case):
    kw = {"default": {}, "m4-M37": dict(min_motif=4, max_motif=37)}.get(
        case, {})
    if case == "tsv":
        tsv = tmp_path / "min_length.tsv"
        tsv.write_text("2\t20\n3\t18\n10\t40\n")
        kw = dict(min_length=str(tsv))
    port, jax_cfg = RibbitConfig.create(**kw), JaxConfig.create(**kw)
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == \
        [(f.name, f.type) for f in dataclasses.fields(jax_cfg)]
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
