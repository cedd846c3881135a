"""The port's Python engine (process_sequence(engine="python")) on the CPU:
over the dense scan's plain versions (pipeline, device="cpu") it gives
the oracle's golden BEDs, the JAX package's Python engine over its XLA
dense scan (scan_backend="tpu") and the port's C core, line for line; the
host route runs it over the numpy scan_host arrays, and RIBBIT_PY_REFINE
runs its refinement over the C core's seeds."""

import pytest
import torch

from ribbit_tpu import pipeline as jax_pipeline
from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.sim import simulate

import ribbit_tpu_torch.scan_dense as sd
from ribbit_tpu_torch import host
from ribbit_tpu_torch import pipeline as pl

torch.set_num_threads(2)


def _oracle(golden_dir, name):
    return (golden_dir / f"{name}.oracle.bed").read_text().splitlines()


@pytest.mark.parametrize("name", ["g1", "g2", "g3"])
def test_python_engine_golden_parity(golden_dir, name):
    n0 = sd.eq_sum8.launches
    lines = pl.process_fasta(str(golden_dir / f"{name}.fa"),
                             RibbitConfig.create(), device="cpu",
                             engine="python")
    assert lines == _oracle(golden_dir, name)
    assert sd.eq_sum8.launches == n0          # CPU tensors launch nothing


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_python_engine_matches_jax_engine_and_core(cpu_jax, trial):
    """tests/test_engine_differential.py's seeds 21000-21002."""
    cfg = RibbitConfig.create()
    sim = simulate(num_loci=4, seed=21000 + trial, name=f"d{trial}",
                   n_block_rate=0.3 if trial % 2 else 0.0)
    got = pl.process_sequence("x", sim.sequence, cfg, device="cpu",
                              engine="python")
    assert got
    assert got == jax_pipeline.process_sequence(
        "x", sim.sequence, cfg, scan_backend="tpu", engine="python")
    assert got == host.process_sequence("x", sim.sequence, cfg)


def test_host_python_engine_and_py_refine(golden_dir, monkeypatch):
    """g1 through the host route's Python engine, then through the C core
    with RIBBIT_PY_REFINE, whose seeds go to the Python refinement."""
    cfg = RibbitConfig.create()
    fa = str(golden_dir / "g1.fa")
    want = _oracle(golden_dir, "g1")
    assert host.process_fasta(fa, cfg, engine="python") == want
    calls = []
    real = host._refine_seeds

    def spy(seeds, *a):
        seeds = list(seeds)
        calls.append(len(seeds))
        return real(seeds, *a)

    monkeypatch.setattr(host, "_refine_seeds", spy)
    monkeypatch.setenv("RIBBIT_PY_REFINE", "1")
    assert host.process_fasta(fa, cfg) == want
    assert calls and calls[0] > 0


def test_unknown_engine_raises(golden_dir):
    cfg = RibbitConfig.create()
    for fn in (pl.process_sequence, host.process_sequence):
        with pytest.raises(ValueError, match="engine"):
            fn("x", "ACGT", cfg, engine="jax")
