"""The port's dense device scan (ribbit_tpu_torch.scan_dense) against the
JAX package: the plain version of the eq_sum8 kernel bit for bit against
the Pallas eq/sum8 kernel (scan_pallas, K10) in interpret mode over the
whole [0, L), and scan_arrays on the CPU against the XLA dense scan
(scan_tpu.scan_arrays) and the port's numpy spec (scan_host), all five
arrays.  Integer and boolean arrays: the tolerance is exact equality.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it against
this plain version there."""

import numpy as np
import pytest
import torch

from ribbit_tpu.config import RibbitConfig
from ribbit_tpu.encode import encode
from ribbit_tpu.sim import simulate

import ribbit_tpu_torch.scan_events as se
from ribbit_tpu_torch import scan_dense as sd
from ribbit_tpu_torch import scan_host
from ribbit_tpu_torch.host import scan_host_arrays

torch.set_num_threads(2)

NAMES = ("eq", "anchors", "overlay", "qual7", "qual6")


def _k10_input(case):
    """tests/test_pallas.py:9's sim at the default config, and :31's random
    700 bp at -m 5 -M 30."""
    if case == "default":
        sim = simulate(num_loci=2, seed=66, name="pl", n_block_rate=0.4)
        return RibbitConfig.create(), encode(sim.sequence)[0]
    rng = np.random.default_rng(4)
    return (RibbitConfig.create(min_motif=5, max_motif=30),
            rng.integers(0, 4, 700).astype(np.int8))


@pytest.mark.parametrize("case", ["default", "m5-M30"])
def test_eq_sum8_ref_matches_pallas_k10(cpu_jax, case):
    from ribbit_tpu.scan_pallas import scan_arrays_pallas
    cfg, code = _k10_input(case)
    eq_p, sum8_p = scan_arrays_pallas(code, cfg, interpret=True)
    eq, sum8 = sd.eq_sum8_ref(torch.from_numpy(code.view(np.uint8)), cfg)
    assert eq.shape == sum8.shape == (cfg.nshifts, code.shape[0])
    assert np.array_equal(eq.numpy().astype(bool), eq_p)
    assert np.array_equal(sum8.numpy().astype(np.int32), sum8_p)
    # the last 7 windows count the zero pad as matches, as K10 does
    assert (sum8_p[:, -1] >= 7).all()


def _edge_input(L):
    rng = np.random.default_rng(L)
    bases = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, L)]
    return encode(bases.tobytes().decode())


def _inputs(case):
    if case == "sim":
        # tests/test_device.py:14's input
        sim = simulate(num_loci=3, seed=21, name="dev", n_block_rate=0.4)
        return encode(sim.sequence)
    return _edge_input(case)


@pytest.mark.parametrize("case", ["sim", 1, 7, 8, 9, 103])
def test_scan_arrays_matches_scan_tpu_and_spec(cpu_jax, case):
    from ribbit_tpu import scan_tpu
    cfg = RibbitConfig.create()
    code, n_mask = _inputs(case)
    got = sd.scan_arrays(code, n_mask, cfg, device="cpu")
    xla = scan_tpu.scan_arrays(code, n_mask, cfg)
    spec = scan_host_arrays(code, n_mask, cfg)
    nw = max(code.shape[0] - 7, 0)
    for name, g, x, s in zip(NAMES, got, xla, spec):
        want_dtype = np.int8 if name.startswith("qual") else bool
        assert g.dtype == want_dtype and g.shape[1] == (
            nw if name.startswith("qual") else code.shape[0]), name
        assert np.array_equal(g, x), name
        assert np.array_equal(g, s), name
    if case == "sim":
        assert all(np.asarray(g == 1).any() for g in got)


def test_scan_arrays_eq_sum8_contract():
    """numpy bool eq and int32 sum8, the scan_arrays_pallas contract, and
    sum8's first L-7 windows are the spec's window popcounts."""
    cfg = RibbitConfig.create(min_motif=5, max_motif=30)
    code, _ = _edge_input(300)
    eq, sum8 = sd.scan_arrays_eq_sum8(code, cfg, device="cpu")
    assert eq.dtype == bool and sum8.dtype == np.int32
    spec = scan_host.match_bitmaps(code, cfg)
    assert np.array_equal(eq, spec)
    cs = np.cumsum(spec, axis=1)
    win = cs[:, 7:] - np.pad(cs[:, :-8], ((0, 0), (1, 0)))
    assert np.array_equal(sum8[:, :300 - 7], win)


def test_wrapper_checks_inputs_and_counts_no_cpu_launches():
    cfg = RibbitConfig.create()
    code = torch.from_numpy(_edge_input(200)[0].view(np.uint8))
    n0 = sd.eq_sum8.launches
    got = sd.eq_sum8(code, cfg)
    want = sd.eq_sum8_ref(code, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sd.eq_sum8.launches == n0
    for bad in (code.to(torch.int32), code[None], code[::2],
                code[:0]):
        with pytest.raises(ValueError):
            sd.eq_sum8(bad, cfg)
    with pytest.raises(ValueError):
        se.device_inputs(np.zeros(5, np.int32), device="cpu")


def test_no_fallback_without_cuda():
    """device="cuda" without CUDA raises; nothing runs on the host
    instead."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the absent-CUDA error cannot occur")
    cfg = RibbitConfig.create()
    code, n_mask = _edge_input(300)
    with pytest.raises(RuntimeError, match="is_available"):
        sd.scan_arrays(code, n_mask, cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        sd.scan_arrays_eq_sum8(code, cfg)
