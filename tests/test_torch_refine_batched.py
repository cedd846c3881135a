"""The port's device-batched refinement (ribbit_tpu_torch.refine_batched)
on the CPU, where the SSW forward passes run the kernels' plain PyTorch
version: BED lines byte-identical, in order, to the reference oracle's
golden files and to ribbit_tpu.refine_batched with the Pallas kernels in
interpret mode, and through the CLI's RIBBIT_BATCHED_REFINE route (the
counterpart of tests/test_refine_batched.py)."""

import pytest
import torch

from ribbit_tpu_torch import align_kernels as ak
from ribbit_tpu_torch.cli import main as cli_main
from ribbit_tpu_torch.config import RibbitConfig
from ribbit_tpu_torch.core import CoreSession
from ribbit_tpu_torch.encode import encode
from ribbit_tpu_torch.fasta import read_fasta
from ribbit_tpu_torch.refine_batched import refine_batched

torch.set_num_threads(2)


def _golden(golden_dir, name):
    return (golden_dir / f"{name}.oracle.bed").read_text().splitlines()


def _port_batched(path):
    cfg = RibbitConfig.create()
    lines = []
    for sid, seq in read_fasta(str(path)):
        code, n_mask = encode(seq)
        sess = CoreSession(code, n_mask, cfg)
        try:
            lines += refine_batched(sess.scan(), seq, sid, code, n_mask,
                                    sess, cfg, device="cpu")
        finally:
            sess.close()
    return lines


@pytest.mark.parametrize("name", ["g1", "g2", "g3"])
def test_batched_refinement_oracle_parity(golden_dir, name):
    n0 = (ak.ssw_forward_small.launches, ak.ssw_forward_large.launches)
    assert _port_batched(golden_dir / f"{name}.fa") == _golden(golden_dir,
                                                               name)
    assert (ak.ssw_forward_small.launches,
            ak.ssw_forward_large.launches) == n0


def test_batched_refinement_equals_jax_package(cpu_jax, golden_dir):
    """g3 through ribbit_tpu.refine_batched (Pallas K3/K4, interpret)."""
    from ribbit_tpu.config import RibbitConfig as JaxConfig
    from ribbit_tpu.core import CoreSession as JaxSession
    from ribbit_tpu.encode import encode as jax_encode
    from ribbit_tpu.refine_batched import refine_batched as jax_refine

    cfg = JaxConfig.create()
    want = []
    for sid, seq in read_fasta(str(golden_dir / "g3.fa")):
        code, n_mask = jax_encode(seq)
        sess = JaxSession(code, n_mask, cfg)
        try:
            want += jax_refine(sess.scan(), seq, sid, code, n_mask, sess,
                               cfg, interpret=True)
        finally:
            sess.close()
    assert _port_batched(golden_dir / "g3.fa") == want


@pytest.mark.parametrize("backend,name", [("gpu", "g1"), ("host", "g2")])
def test_batched_refinement_via_cli_env(golden_dir, tmp_path, monkeypatch,
                                        backend, name):
    """The RIBBIT_BATCHED_REFINE route of the CLI, forward on --device."""
    monkeypatch.setenv("RIBBIT_BATCHED_REFINE", "1")
    calls = []
    real = ak.ssw_forward_ref
    monkeypatch.setattr(ak, "ssw_forward_ref",
                        lambda p: calls.append(p.n) or real(p))
    out = tmp_path / "out.bed"
    assert cli_main(["--backend", backend, "--device", "cpu",
                     "-i", str(golden_dir / f"{name}.fa"),
                     "-o", str(out)]) == 0
    assert out.read_text().splitlines() == _golden(golden_dir, name)
    assert calls, "the batched route did not score on the device path"


@pytest.mark.parametrize("cap", ["pipeline", "host"])
def test_over_cap_batched_route_keeps_device(golden_dir, tmp_path,
                                             monkeypatch, cap):
    """Contigs past the cap (lowered here to g1's longest contig) go to the
    host's over-cap paths (pipeline._over_cap; host's auto-chunking and
    split chunks); with RIBBIT_BATCHED_REFINE their forward passes still
    run on --device cpu."""
    from ribbit_tpu_torch import host, pipeline
    fa = golden_dir / "g1.fa"
    longest = max(len(seq) for _, seq in read_fasta(str(fa)))
    monkeypatch.setattr(pipeline if cap == "pipeline" else host,
                        "MAX_CONTIG", longest)
    monkeypatch.setenv("RIBBIT_BATCHED_REFINE", "1")
    calls = []
    real = ak.ssw_forward_ref
    monkeypatch.setattr(ak, "ssw_forward_ref",
                        lambda p: calls.append(p.n) or real(p))
    out = tmp_path / "out.bed"
    backend = "gpu" if cap == "pipeline" else "host"
    assert cli_main(["--backend", backend, "--device", "cpu",
                     "-i", str(fa), "-o", str(out)]) == 0
    assert calls, "the over-cap contig was not scored on the device path"
    if cap == "pipeline":
        assert out.read_text().splitlines() == _golden(golden_dir, "g1")
