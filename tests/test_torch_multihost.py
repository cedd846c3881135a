"""The port's multi-host mode (ribbit_tpu_torch.parallel.multihost, gloo
collectives over torch.distributed): two real CLI processes on the CPU
(--device cpu) write, from rank 0, a BED byte-identical to the port's
single-process run and to the JAX package's process_sequence; a stalled
collective surfaces as a TimeoutError that points at --resume; the CLI's
refusals; and no module of jax or ribbit_tpu is loaded by a --coordinator
run (the counterpart of tests/test_multihost.py)."""

import os
import socket
import subprocess
import sys
import time

import pytest

from ribbit_tpu.config import RibbitConfig as JaxConfig
from ribbit_tpu.pipeline import process_sequence as jax_process_sequence

from ribbit_tpu_torch.cli import main as cli_main
from ribbit_tpu_torch.parallel import multihost
from ribbit_tpu_torch.sim import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _genome():
    """tests/test_multihost.py:24's four sims with N * 800 between."""
    parts = []
    for ci in range(4):
        parts.append(simulate(num_loci=4, seed=700 + ci,
                              name=f"d{ci}").sequence)
        parts.append("N" * 800)
    return "".join(parts)


def _write_fasta(path, genome):
    with open(path, "w") as fh:
        fh.write(">chr\n")
        for i in range(0, len(genome), 80):
            fh.write(genome[i:i + 80] + "\n")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    # a small torch thread pool a process: two ranks share this machine
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra)
    return env


def _run_ranks(cmds, env):
    """Start one process per command, wait for all (each with a timeout),
    and return their (returncode, stderr); a rank that is still running at
    the timeout is killed and fails the test."""
    procs = [subprocess.Popen(c, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _rank_argv(fa, port, pid, extra=()):
    return ["-i", str(fa), "--device", "cpu",
            "--coordinator", f"localhost:{port}", "--num-processes", "2",
            "--process-id", str(pid), *extra]


@pytest.mark.parametrize("chunk", ["12000", "100000"],
                         ids=["five-chunks", "one-chunk"])
def test_two_process_multihost_byte_identical(tmp_path, chunk):
    """Two ranks at --chunk-size 12000 (five chunks, three and two a rank)
    and at one chunk (every rank computes it): rank 0's BED equals the
    port's single-process run and the JAX package's output."""
    genome = _genome()
    fa = tmp_path / "g.fa"
    _write_fasta(fa, genome)
    port = _free_port()
    cmds = []
    for pid in range(2):
        extra = ["--chunk-size", chunk, "--timing"]
        if pid == 0:
            extra += ["-o", str(tmp_path / "mh.bed")]
        cmds.append([sys.executable, "-m", "ribbit_tpu_torch.cli",
                     *_rank_argv(fa, port, pid, extra)])
    results = _run_ranks(cmds, _env())
    for rc, so, se in results:
        assert rc == 0, se
    assert results[1][1] == ""                 # only rank 0 writes
    if chunk == "12000":
        assert "[p0] chr: 3/5 chunks" in results[0][2]
        assert "[p1] chr: 2/5 chunks" in results[1][2]
    assert "Done:" in results[0][2] and "Done:" not in results[1][2]

    single = tmp_path / "single.bed"
    assert cli_main(["-i", str(fa), "--device", "cpu", "-o",
                     str(single)]) == 0
    mh = (tmp_path / "mh.bed").read_text()
    assert mh and mh == single.read_text()
    assert mh.splitlines() == jax_process_sequence("chr", genome,
                                                   JaxConfig.create())


_PROBE = r"""
import sys
from ribbit_tpu_torch.cli import main
rc = main(sys.argv[1:])
foreign = [m for m in sys.modules if m in ("jax", "ribbit_tpu")
           or m.startswith(("jax.", "ribbit_tpu."))]
assert not foreign, foreign
print("NO_JAX_OK")
sys.exit(rc)
"""


def test_multihost_run_imports_nothing_of_jax(golden_dir, tmp_path):
    """Neither jax nor any module of ribbit_tpu is loaded by a
    --coordinator run of the port's CLI (g3 in three chunks)."""
    port = _free_port()
    out = tmp_path / "mh.bed"
    cmds = [[sys.executable, "-c", _PROBE,
             *_rank_argv(golden_dir / "g3.fa", port, pid,
                         ["--chunk-size", "6000"]
                         + (["-o", str(out)] if pid == 0 else []))]
            for pid in range(2)]
    for rc, so, se in _run_ranks(cmds, _env()):
        assert rc == 0, se
        assert "NO_JAX_OK" in so
    assert out.read_text() == (golden_dir / "g3.oracle.bed").read_text()


def test_collective_watchdog_detects_stall(monkeypatch):
    """A stalled peer surfaces as a TimeoutError pointing at --resume, not
    an endless hang; the abandoned worker is a daemon thread (a non-daemon
    one would hang the process again at exit)."""
    import threading

    monkeypatch.setenv("RIBBIT_COLLECTIVE_TIMEOUT", "0.2")
    with pytest.raises(TimeoutError, match="--resume"):
        multihost._with_deadline(time.sleep, 5, what="test stall")
    stalled = [t for t in threading.enumerate()
               if t.name == "ribbit-test stall"]
    assert stalled and all(t.daemon for t in stalled)
    # fast calls pass through; exceptions relay to the caller
    assert multihost._with_deadline(lambda x: x + 1, 41) == 42
    with pytest.raises(ValueError, match="boom"):
        multihost._with_deadline(
            lambda: (_ for _ in ()).throw(ValueError("boom")))
    # unset: a direct call, no watchdog thread
    monkeypatch.delenv("RIBBIT_COLLECTIVE_TIMEOUT")
    assert multihost._with_deadline(lambda x: x * 2, 21) == 42


_STALLED_PEER = r"""
import sys, time
from ribbit_tpu_torch.parallel.multihost import ensure_initialized
ensure_initialized(sys.argv[1], 2, 1)
time.sleep(120)
"""


def test_stalled_peer_times_out_the_gather(tmp_path):
    """Rank 1 joins the group and never reaches a collective: rank 0's
    first all-gather of event fragments never returns, and under
    RIBBIT_COLLECTIVE_TIMEOUT rank 0 exits non-zero naming the step,
    without writing a BED line."""
    fa = tmp_path / "g.fa"
    _write_fasta(fa, _genome())
    port = _free_port()
    out = tmp_path / "mh.bed"
    peer = subprocess.Popen([sys.executable, "-c", _STALLED_PEER,
                             f"localhost:{port}"], env=_env(), cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "ribbit_tpu_torch.cli",
                            *_rank_argv(fa, port, 0,
                                        ["--chunk-size", "12000", "-o",
                                         str(out)])],
                           env=_env(RIBBIT_COLLECTIVE_TIMEOUT="3"), cwd=REPO,
                           capture_output=True, text=True, timeout=TIMEOUT)
        waited = time.perf_counter() - t
    finally:
        peer.kill()
        peer.wait()
    assert r.returncode != 0
    assert "TimeoutError: multihost length allgather exceeded " \
        "RIBBIT_COLLECTIVE_TIMEOUT=3s" in r.stderr
    assert "--resume" in r.stderr
    assert out.read_text() == ""
    assert waited < TIMEOUT


@pytest.mark.parametrize("extra,message", [
    (["--resume"], "--resume is not supported with --coordinator"),
    (["--backend", "host"], "--backend host is single-process"),
    (["--device", "cuda"], None)], ids=["resume", "backend-host", "no-cuda"])
def test_multihost_refusals_exit_2(golden_dir, tmp_path, capsys, extra,
                                   message):
    """--coordinator with --resume, with --backend host, or on --device cuda
    without CUDA exits 2 before it joins a group (the coordinator named
    here does not exist) and writes no output."""
    import torch
    if message is None:
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA")
        message = "torch.cuda.is_available() is False"
    out = tmp_path / "out.bed"
    argv = ["-i", str(golden_dir / "g3.fa"), "-o", str(out),
            "--coordinator", "localhost:1", "--num-processes", "2",
            "--process-id", "0", *extra]
    assert cli_main(argv) == 2
    assert message in capsys.readouterr().err
    assert not out.exists()


def test_pack_clipped_round_trips():
    import numpy as np
    ch = np.array([0, 0, 3], np.int64)
    s = np.array([5, 90, 7], np.int64)
    e = np.array([20, 99, 40], np.int64)
    for a, b in zip(multihost._unpack_clipped(
            multihost._pack_clipped(ch, s, e)), (ch, s, e)):
        assert np.array_equal(a, b)
    assert all(x.shape == (0,) for x in multihost._unpack_clipped(
        multihost._pack_clipped(*(np.zeros(0, np.int64),) * 3)))
