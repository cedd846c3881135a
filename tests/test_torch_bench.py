"""The port's bench (ribbit_tpu_torch.bench_device) and roofline
(ribbit_tpu_torch.bench_roofline) on the CPU: the int32 probe's plain
version bit for bit against the Pallas probe in interpret mode and both
against the probe's closed form, the SASS loop count and the folding guard
on listings, the byte and operation counts behind the bounds and the
roofline shares, every key of the bench, no fallback without CUDA and no
jax after a run.

The probe kernel and the timed benches run only on a card;
chip_smoke.py runs them there."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ribbit_tpu_torch import bench_device as bd
from ribbit_tpu_torch import bench_roofline as br
from ribbit_tpu_torch.config import RibbitConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"device", "gpu_scan_mbps", "gpu_scan_channels", "gpu_event_mbps",
        "host_decode_mbps", "gpu_align_pairs_per_s", "gpu_align_gcups",
        "int32_alu_tops", "int32_spec_tops", "gpu_scan_hbm_frac",
        "gpu_event_hbm_frac", "gpu_align_alu_frac"}


@pytest.mark.parametrize("ops,trips", [(8, 3), (16, 1)])
def test_alu_probe_ref_matches_pallas(cpu_jax, ops, trips):
    """OPS and TRIPS patched small (an odd number of XOR rounds, so the
    odd chains do not return to x + j) and restored."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import ribbit_tpu.bench_roofline as jbr

    x = np.random.default_rng(0).integers(-2**31, 2**31, (jbr.ROWS, 256),
                                          dtype=np.int64).astype(np.int32)
    saved = (jbr.OPS, jbr.TRIPS)
    jbr.OPS, jbr.TRIPS = ops, trips
    try:
        want = np.asarray(pl.pallas_call(
            jbr._alu_kernel,
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
            interpret=True)(jnp.asarray(x)))
    finally:
        jbr.OPS, jbr.TRIPS = saved
    got = br.alu_probe(torch.from_numpy(x.ravel()), ops, trips)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().reshape(x.shape), want)
    assert not np.array_equal(want, x.astype(np.int64) * 8 + 28)


def probe_closed_form(x: np.ndarray, ops: int, trips: int) -> np.ndarray:
    """The probe's function in closed form: after R = ops / 8 x trips
    rounds an even chain holds x + j + j R, an odd chain x + j, XORed with
    j + 17 when R is odd; the output is their int32-wrapped sum."""
    r = ops // 8 * trips
    x = x.astype(np.int64)
    total = sum(x + j + j * r if j % 2 == 0
                else (x + j) ^ (j + 17) if r % 2 else x + j
                for j in range(8))
    return ((total + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("against,ops,trips", [
    ("plain", 8, 3), ("plain", 24, 1), ("plain", 8, 7), ("plain", 16, 5),
    ("plain", 32, 2), ("pallas", br.OPS, br.TRIPS)])
def test_alu_probe_closed_form(request, against, ops, trips):
    """The closed form against the plain version at small odd and even
    round counts, and against the Pallas probe in interpret mode at the
    full OPS x TRIPS, so the full-size expectation does not rest on the
    plain loop alone."""
    x = np.random.default_rng(1).integers(-2**31, 2**31, (br.ROWS, 256),
                                          dtype=np.int64).astype(np.int32)
    want = probe_closed_form(x, ops, trips)
    if against == "plain":
        got = br.alu_probe_ref(torch.from_numpy(x.ravel()), ops,
                               trips).numpy().reshape(x.shape)
    else:
        request.getfixturevalue("cpu_jax")
        import jax
        import jax.numpy as jnp
        from jax.experimental import pallas as pl

        import ribbit_tpu.bench_roofline as jbr

        assert (jbr.OPS, jbr.TRIPS) == (ops, trips)
        got = np.asarray(pl.pallas_call(
            jbr._alu_kernel,
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
            interpret=True)(jnp.asarray(x)))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_alu_probe_checks_its_arguments():
    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        br.alu_probe(x, 12, 1)
    with pytest.raises(ValueError, match="int32"):
        br.alu_probe(x.to(torch.int64), 8, 1)


SASS = """
        code for sm_90a
                Function : alu_probe_kernel
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0020*/                   IADD3 R2, R2, c[0x0][0x218], RZ ;
        /*0030*/                   LOP3.LUT R3, R3, c[0x0][0x21c], RZ, 0x3c, !PT ;
        /*0040*/                   UIADD3 UR4, UR4, 0x20, URZ ;
        /*0050*/                   IMAD.IADD R4, R4, 0x1, R5 ;
        /*0058*/                   VIADD R5, R5, UR4 ;
        /*0060*/                   ISETP.GE.AND P0, PT, R6, R7, PT ;
        /*0070*/               @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0080*/                   IADD3 R2, R2, c[0x0][0x218], RZ ;
        /*0090*/                   BRA 0x80 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_loop_counts_the_longest_loop():
    """Lane instructions of the longest backward-branch loop: no branch,
    no uniform-datapath instruction."""
    loop = br.sass_loop(SASS)
    assert loop["instructions"] == 5
    assert loop["opcodes"] == {"IADD3": 1, "LOP3": 1, "IMAD": 1, "VIADD": 1,
                               "ISETP": 1}
    with pytest.raises(RuntimeError, match="no backward branch"):
        br.sass_loop("        /*0000*/  EXIT ;\n")


def loop_listing(opcodes) -> str:
    """A SASS listing whose one loop holds these opcodes in order."""
    lines = ["        code for sm_90a", "                Function : k",
             "        /*0000*/                   S2R R0, SR_TID.X ;",
             ".L_x_0:"]
    addr = 0x10
    for op in opcodes:
        lines.append(f"        /*{addr:04x}*/                   {op} R2, R2, "
                     f"R3, R4 ;")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/                   UIADD3 UR4, UR4, "
                 f"0x2, URZ ;")
    lines.append(f"        /*{addr + 0x10:04x}*/               @P0 BRA "
                 f"`(.L_x_0) ;")
    lines.append(f"        /*{addr + 0x20:04x}*/                   EXIT ;")
    return "\n".join(lines)


@pytest.mark.parametrize("body,rounds,folded", [
    (["IMAD", "LOP3"] * 8 + ["ISETP"], 2, False),
    (["IMAD", "LOP3"] * 4 + ["IMAD"] * 4 + ["ISETP"], 2, True),
    (["IMAD", "LOP3"] * 7 + ["ISETP"], 2, True),
    (["IMAD", "LOP3"] * 7 + ["IMAD", "ISETP"], 2, True),
    (["IMAD", "LOP3"] * 512 + ["ISETP"], 128, False)],
    ids=["whole", "xors-dropped", "pair-fused", "one-short", "kept-body"])
def test_check_probe_loop_refuses_a_folded_body(body, rounds, folded):
    """A body of two rounds covers 16 source operations: whole (8 IMAD, 8
    LOP3, the compare) it passes; with XORs dropped in pairs, with one
    round's pair fused away, or with a single operation fused (15 chain
    instructions and the compare: 16 instructions, not enough once the
    compare is left out), it holds fewer chain instructions than
    operations and the guard raises.  The kept probe's body of 128 rounds
    (512 IMAD, 512 LOP3, one ISETP for 1,024 operations) passes."""
    loop = br.sass_loop(loop_listing(body))
    assert loop["instructions"] == len(body)
    if folded:
        with pytest.raises(RuntimeError, match="folded"):
            br.check_probe_loop(loop, rounds)
    else:
        br.check_probe_loop(loop, rounds)


def test_scan_and_probe_work():
    """The default configuration's exact bytes and operations: anchor
    planes 12.75 B/bp for 102 shift rows; the event pass 52 B/bp written
    for 104 plane rows and 12.375 B/bp of packed overlay for 99 motif rows;
    the dense pass 396 B/bp for 99 motif rows; the probe's 8.59 G
    operations on its tile."""
    cfg, L = RibbitConfig.create(), 4096
    assert br.scan_work("anchor_planes", L, cfg) == (L * (1 + 12.75),
                                                     L * 102)
    assert br.scan_work("event_words", L, cfg) == (
        L * (2 + 12.75 + 52 + 12.375), L * 104 * 4)
    assert br.scan_work("dense_masks", L, cfg) == (L * (2 + 12.75 + 396),
                                                   L * 99 * 5)
    assert br.probe_work() == (8 * 8 * 16384, 8_589_934_592)
    f = br.roofline({"gpu_scan_mbps": 1e3, "gpu_event_mbps": None,
                     "gpu_align_gcups": 100.0, "int32_alu_tops": 10.0}, L)
    assert f["gpu_scan_hbm_frac"] == pytest.approx(1e9 * 424.5 / 3.35e12)
    assert f["gpu_event_hbm_frac"] is None
    assert f["gpu_align_alu_frac"] == pytest.approx(100e9 * 3.5 / 10e12)


def test_run_device_bench_on_cpu_returns_every_key(monkeypatch):
    """The plain versions run (16 pairs for the aligner); every device
    number is None on the CPU."""
    monkeypatch.setattr(bd, "PAIRS", 16)
    out = bd.run_device_bench(device="cpu", L=4096)
    assert set(out) == KEYS
    assert out["device"] == "cpu"
    assert out["gpu_scan_channels"] == 99
    assert out["host_decode_mbps"] > 0
    assert all(out[k] is None for k in KEYS - {
        "device", "gpu_scan_channels", "host_decode_mbps"})


def test_run_device_bench_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the absent-CUDA error cannot occur")
    with pytest.raises(RuntimeError, match="is_available"):
        bd.run_device_bench(device="cuda", L=4096)
    with pytest.raises(RuntimeError, match="is_available"):
        br.int32_ceiling("cuda")


_PROBE = r"""
import json, runpy, sys
from ribbit_tpu_torch import bench_device
bench_device.PAIRS = 4
print(json.dumps(bench_device.run_device_bench(device="cpu", L=2048)))
try:
    runpy.run_module("ribbit_tpu_torch.bench_device", run_name="__main__")
except RuntimeError as e:
    assert "is_available" in str(e), e
else:
    raise AssertionError("the bench ran without CUDA")
foreign = [m for m in sys.modules if m in ("jax", "ribbit_tpu")
           or m.startswith(("jax.", "ribbit_tpu."))]
assert not foreign, foreign
print("NO_JAX_OK")
"""


def test_bench_entry_point_needs_no_jax():
    """The bench's entry point, run as __main__ without CUDA, raises and
    prints nothing; with the bench on the CPU it leaves no jax and nothing
    of ribbit_tpu loaded."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the entry point would run the bench")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    out = r.stdout.splitlines()
    assert out[-1] == "NO_JAX_OK" and len(out) == 2
    assert json.loads(out[0])["gpu_scan_channels"] == 99
    r = subprocess.run([sys.executable, "-m", "ribbit_tpu_torch.bench_device"],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0 and "is_available" in r.stderr
    assert r.stdout == ""
