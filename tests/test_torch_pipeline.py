"""The port's pipeline and CLI (ribbit_tpu_torch.pipeline / .cli) on the
CPU, where the gpu backend runs the kernels' plain PyTorch versions: BED
output byte-identical, in order, to the reference oracle's golden files
and to ribbit_tpu's host path, through the serial route, the multi-contig
overlap loop and the CLI; and no silent host run when CUDA is asked for
and absent."""

import json
import os
import subprocess
import sys

import pytest
import torch

from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.sim import simulate

import ribbit_tpu_torch.pipeline as pl
import ribbit_tpu_torch.scan_events as se
from ribbit_tpu_torch.backend import resolve_backend
from ribbit_tpu_torch.cli import build_parser, main as cli_main

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = ("g1", "g2", "g3")


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


@pytest.fixture()
def golden_multi(golden_dir, tmp_path):
    """g1 + an empty record + g2 + g3 in one FASTA, and the oracle's BED
    lines for it in order."""
    fa = tmp_path / "g123.fa"
    parts = [(golden_dir / f"{g}.fa").read_text() for g in GOLDEN]
    fa.write_text(parts[0] + ">empty\n\n" + parts[1] + parts[2])
    want = []
    for g in GOLDEN:
        want += (golden_dir / f"{g}.oracle.bed").read_text().splitlines()
    return fa, want


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_parity_serial(golden_dir, name):
    """One contig per file: the serial route, process_sequence."""
    cfg = RibbitConfig.create()
    lines = pl.process_fasta(str(golden_dir / f"{name}.fa"), cfg,
                             device="cpu")
    assert lines == (golden_dir / f"{name}.oracle.bed").read_text() \
        .splitlines()


def test_golden_parity_overlap_loop(golden_multi, monkeypatch):
    fa, want = golden_multi
    calls = []
    real = pl._fasta_records_overlap
    monkeypatch.setattr(pl, "_fasta_records_overlap",
                        lambda *a: calls.append(1) or real(*a))
    records = list(pl.process_fasta_records(str(fa), RibbitConfig.create(),
                                            device="cpu"))
    assert calls == [1]
    assert [r[0] for r in records] == ["g1", "empty", "g2", "g3"]
    assert records[1][1:] == (0, [])
    assert [l for r in records for l in r[2]] == want


def test_cli_subprocess_golden_parity(golden_multi, tmp_path):
    fa, want = golden_multi
    out = tmp_path / "out.bed"
    r = subprocess.run([sys.executable, "-m", "ribbit_tpu_torch.cli",
                        "--backend", "gpu", "--device", "cpu", "-i", str(fa),
                        "-o", str(out)], capture_output=True, text=True,
                       env=_env(), cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert out.read_text().splitlines() == want
    assert "[gpu]" in r.stderr


def test_cli_resume(golden_multi, tmp_path, capsys):
    """--resume skips finished contigs and keeps the output."""
    fa, want = golden_multi
    out = tmp_path / "out.bed"
    args = ["--backend", "gpu", "--device", "cpu", "--resume",
            "-i", str(fa), "-o", str(out)]
    assert cli_main(args) == 0
    assert out.read_text().splitlines() == want
    manifest = json.loads((tmp_path / "out.bed.manifest.json").read_text())
    assert set(manifest["contigs"]) == {"g1", "empty", "g2", "g3"}
    capsys.readouterr()
    assert cli_main(args) == 0
    assert "Resuming: 4 contig(s) already done" in capsys.readouterr().err
    assert out.read_text().splitlines() == want


def test_host_backend_matches_golden(golden_multi, tmp_path):
    """--backend host, with --chunk-size small enough that g1-g3 go
    through ribbit_tpu's chunked event capture."""
    fa, want = golden_multi
    out = tmp_path / "out.bed"
    assert cli_main(["--backend", "host", "--chunk-size", "4000",
                     "-i", str(fa), "-o", str(out)]) == 0
    assert out.read_text().splitlines() == want


def test_gpu_without_cuda_fails_loudly(golden_dir, tmp_path):
    """--backend gpu --device cuda on a machine without CUDA exits non-zero
    and writes no BED line: no silent run on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = tmp_path / "out.bed"
    r = subprocess.run([sys.executable, "-m", "ribbit_tpu_torch",
                        "--backend", "gpu", "--device", "cuda",
                        "-i", str(golden_dir / "g3.fa"), "-o", str(out)],
                       capture_output=True, text=True, env=_env(), cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not out.exists() or out.read_text() == ""
    with pytest.raises(RuntimeError):
        pl.process_sequence("x", "ACGT" * 100, RibbitConfig.create(),
                            device="cuda")


def test_launch_counters_stay_zero_on_cpu(golden_dir):
    a0, e0 = se.anchor_planes.launches, se.event_words.launches
    pl.process_fasta(str(golden_dir / "g3.fa"), RibbitConfig.create(),
                     device="cpu")
    assert (se.anchor_planes.launches, se.event_words.launches) == (a0, e0)


def test_overlap_prefetch_is_bounded(tmp_path, monkeypatch):
    """At most PREFETCH contigs are extracted beyond the one being
    refined."""
    fa = tmp_path / "many.fa"
    with open(fa, "w") as fh:
        for ci in range(8):
            fh.write(f">c{ci}\n"
                     f"{simulate(num_loci=1, seed=60 + ci).sequence}\n")
    state = {"started": 0, "consumed": 0, "max_ahead": 0}
    real = pl.extract_events

    def spy(*a, **kw):
        state["started"] += 1
        state["max_ahead"] = max(state["max_ahead"],
                                 state["started"] - state["consumed"])
        return real(*a, **kw)

    monkeypatch.setattr(pl, "extract_events", spy)
    host = pl.process_fasta(str(fa), RibbitConfig.create(),
                            scan_backend="host")
    lines = []
    for _sid, _n, r in pl.process_fasta_records(str(fa),
                                                RibbitConfig.create(),
                                                device="cpu"):
        state["consumed"] += 1
        lines += r
    assert state["started"] == 8
    assert state["max_ahead"] <= pl.PREFETCH + 1, state
    assert lines == host


def test_over_cap_contig_goes_to_host_path(tmp_path, monkeypatch, capsys):
    s0 = simulate(num_loci=2, seed=70).sequence
    s1 = simulate(num_loci=3, seed=71).sequence
    fa = tmp_path / "oc.fa"
    fa.write_text(f">c0\n{s0}\n>c1\n{s1}\n")
    cfg = RibbitConfig.create()
    host = pl.process_fasta(str(fa), cfg, scan_backend="host")
    monkeypatch.setattr(pl, "MAX_CONTIG", max(len(s0), len(s1)))
    capsys.readouterr()
    assert pl.process_fasta(str(fa), cfg, device="cpu") == host
    assert "host's chunked path" in capsys.readouterr().err


def test_multihost_flags_are_refused(golden_dir, tmp_path, capsys):
    """Multi-host mode (--coordinator) refuses --resume before it joins a
    group (the coordinator named here does not exist); --num-processes and
    --process-id without --coordinator leave the run single-process, as in
    ribbit_tpu.cli."""
    fa = golden_dir / "g3.fa"
    out = tmp_path / "out.bed"
    assert cli_main(["--coordinator", "h:1", "--resume", "--device", "cpu",
                     "-i", str(fa), "-o", str(out)]) == 2
    assert "--resume is not supported with --coordinator" in \
        capsys.readouterr().err
    assert not out.exists()
    for extra in (["--num-processes", "2"], ["--process-id", "1"]):
        assert cli_main(extra + ["--device", "cpu", "-i", str(fa),
                                 "-o", str(out)]) == 0
        assert out.read_text() == (golden_dir / "g3.oracle.bed").read_text()


def test_resolve_backend(capsys):
    """gpu unless host is named: auto is an alias of gpu, whether or not
    this machine has CUDA."""
    assert resolve_backend("gpu") == "gpu"
    assert resolve_backend("host") == "host"
    assert resolve_backend("auto") == "gpu"
    assert "backend auto -> gpu" in capsys.readouterr().err
    assert resolve_backend() == "gpu"
    assert build_parser().parse_args(["-i", "x.fa"]).backend == "gpu"
    with pytest.raises(ValueError):
        resolve_backend("tpu")


@pytest.mark.parametrize("argv,batched", [
    (["--backend", "auto"], False), ([], False), (["--backend", "gpu"], True),
    (["--backend", "host"], True)], ids=["auto", "default", "gpu-batched",
                                          "host-batched"])
def test_no_cuda_exits_nonzero_without_output(golden_dir, tmp_path, argv,
                                              batched):
    """Without CUDA, every run that needs the card (the default, auto, and
    the batched route on either backend) exits non-zero before writing a
    BED line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = tmp_path / "out.bed"
    env = _env()
    if batched:
        env["RIBBIT_BATCHED_REFINE"] = "1"
    r = subprocess.run([sys.executable, "-m", "ribbit_tpu_torch", *argv,
                        "-i", str(golden_dir / "g3.fa"), "-o", str(out)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not out.exists()
