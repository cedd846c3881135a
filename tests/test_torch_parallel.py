"""The port's multi-device layer (ribbit_tpu_torch.parallel) on lists of CPU
devices, against the JAX package's ribbit_tpu.parallel on its forced
8-device CPU mesh: the sharded scan's eq, counts and total bit for bit,
distributed contig processing's BED byte for byte (and against the port's
host route), the split SSW forward's four outputs bit for bit, and the
split refinement's BED against the oracle's.  Integer outputs and BED
lines: the tolerance is exact equality.

On a CPU device the kernels' plain PyTorch versions run; chip_smoke.py
holds the kernels against them on the card and drives these routes there
over lists that repeat cuda:0."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from ribbit_tpu.config import RibbitConfig as JaxConfig

from ribbit_tpu_torch import align_kernels as ak
from ribbit_tpu_torch import backend, host, pipeline
from ribbit_tpu_torch.config import RibbitConfig
from ribbit_tpu_torch.core import CoreSession
from ribbit_tpu_torch.encode import encode
from ribbit_tpu_torch.fasta import read_fasta
from ribbit_tpu_torch.parallel import distributed, make_mesh, \
    sharded_scan_step
from ribbit_tpu_torch.parallel.multihost import multihost_process_contig
from ribbit_tpu_torch.parallel.sharded_refine import batch_forward_sharded, \
    refine_batched_sharded
from ribbit_tpu_torch.parallel.sharded_scan import blocks, map_blocks, \
    map_items
from ribbit_tpu_torch.sim import simulate

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


# ---------------------------------------------------------------------------
# make_mesh and the split
# ---------------------------------------------------------------------------

def test_make_mesh_takes_cpu_lists_and_refuses_the_rest():
    assert make_mesh(devices=CPU8) == [torch.device("cpu")] * 8
    assert make_mesh(3, devices=CPU8) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="9 devices asked for"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="no device"):
        make_mesh(devices=[])
    with pytest.raises(ValueError, match="unsupported"):
        make_mesh(devices=["meta"])
    if not torch.cuda.is_available():
        for kw in ({}, {"n_devices": 1}, {"devices": ["cuda"]},
                   {"devices": ["cpu", "cuda:0"]}):
            with pytest.raises(RuntimeError, match="is_available"):
                make_mesh(**kw)


@pytest.mark.parametrize("n,ndev", [(8, 8), (5, 3), (2, 8), (0, 2), (7, 1)])
def test_blocks_split_contiguously(n, ndev):
    """Contiguous blocks of ceil(n / ndev) in order, as a sharded axis
    splits rows: every item once, at most ndev blocks."""
    bs = blocks(n, ndev)
    assert len(bs) == ndev
    assert [i for b in bs for i in b] == list(range(n))
    per = max(1, -(-n // ndev))
    assert all(len(b) <= per for b in bs)


def test_map_blocks_threads_per_distinct_device_and_keeps_order():
    """Distinct devices run in threads of their own, a repeated device's
    blocks in order in one thread; results come back in block order, not
    completion order; the first failure raises."""
    devs = [torch.device("cpu", k) for k in (0, 1, 0, 2)]
    seen = []

    def fn(d, r):
        time.sleep(0.01 * (3 - d.index))     # later blocks finish first
        seen.append((d.index, threading.current_thread().name, list(r)))
        return list(r)

    assert map_blocks(devs, 10, fn) == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                        [9]]
    by_dev = {}
    for idx, name, r in seen:
        by_dev.setdefault(idx, []).append((name, r))
    assert [r for _n, r in by_dev[0]] == [[0, 1, 2], [6, 7, 8]]
    assert len({n for n, _r in by_dev[0]}) == 1
    assert len({n for d in by_dev for n, _r in by_dev[d]}) == 3
    assert map_items(devs, 6, lambda d, i: (d.index, i)) == [
        (0, 0), (0, 1), (1, 2), (1, 3), (0, 4), (0, 5)]
    # one distinct device: the calling thread runs every block
    caller = threading.current_thread().name
    assert map_items([torch.device("cpu")] * 3, 4,
                     lambda d, i: threading.current_thread().name) == \
        [caller] * 4

    def boom(d, r):
        if d.index == 1:
            raise ValueError("device 1 failed")
        return r

    with pytest.raises(ValueError, match="device 1 failed"):
        map_blocks(devs, 10, boom)


def test_count_launch_loses_no_update():
    """The wrappers' launch counts stay exact under more threads than
    cores, with a short switch interval."""
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [backend.count_launch(wrapper)
                                               for _ in range(2000)])
              for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000


# ---------------------------------------------------------------------------
# sharded_scan_step (K10 per chunk) against the JAX package
# ---------------------------------------------------------------------------

def _scan_inputs(case):
    """tests/test_device.py:100's random (8, 256) codes at motifs 2-12, and
    the same with N runs (code 0 under N, as encode gives)."""
    rng = np.random.default_rng(5)
    code = rng.integers(0, 4, (8, 256)).astype(np.int8)
    n_mask = np.zeros((8, 256), dtype=bool)
    if case == "n-runs":
        for b in range(8):
            for _ in range(3):
                a = int(rng.integers(0, 256))
                n_mask[b, a:a + int(rng.integers(1, 20))] = True
        n_mask[3] = True                      # an all-N chunk
        n_mask[5, 249:] = True                # N in the last windows
        code[n_mask] = 0
    return code, n_mask


@pytest.mark.parametrize("case", ["no-n", "n-runs"])
def test_sharded_scan_matches_jax(cpu_jax, case):
    from ribbit_tpu.parallel import make_mesh as jax_mesh
    from ribbit_tpu.parallel import sharded_scan_step as jax_step
    from ribbit_tpu.parallel.sharded_scan import _chunk_scan

    cfg = RibbitConfig.create(min_motif=2, max_motif=12)
    jcfg = JaxConfig.create(min_motif=2, max_motif=12)
    code, n_mask = _scan_inputs(case)
    eq, counts, total = sharded_scan_step(make_mesh(devices=CPU8), cfg)(
        code, n_mask)

    import jax.numpy as jnp
    eq_ref, counts_ref = _chunk_scan(jnp.asarray(code), jnp.asarray(n_mask),
                                     min_shift=jcfg.min_shift,
                                     nshifts=jcfg.nshifts)
    eq_sh, counts_sh, total_sh = jax_step(jax_mesh(8), jcfg)(code, n_mask)
    assert eq.shape == (8, cfg.nshifts, 256) and eq.dtype == torch.bool
    for e in (eq_ref, eq_sh):
        assert np.array_equal(eq.numpy(), np.asarray(e))
    for c in (counts_ref, counts_sh):
        assert np.array_equal(counts.numpy(), np.asarray(c))
    assert int(total[0]) == int(total_sh[0]) == int(counts.sum())
    assert int(total[0]) > 0
    if case == "n-runs":
        assert not counts[3].any()


@pytest.mark.parametrize("devs", [["cpu"] * 3, ["cpu"] * 16])
def test_sharded_scan_refuses_chunks_that_do_not_divide(devs):
    cfg = RibbitConfig.create(min_motif=2, max_motif=12)
    code, n_mask = _scan_inputs("no-n")
    with pytest.raises(ValueError, match="do not divide"):
        sharded_scan_step(make_mesh(devices=devs), cfg)(code, n_mask)


# ---------------------------------------------------------------------------
# distributed_process_contig (K1/K2 per chunk) against the JAX package
# ---------------------------------------------------------------------------

def _genome(name):
    """tests/test_distributed.py:9's four sims with N * 800 between, and
    :27's dense sim."""
    if name == "four-sims":
        parts = []
        for ci in range(4):
            parts.append(simulate(num_loci=4, seed=700 + ci,
                                  name=f"d{ci}").sequence)
            parts.append("N" * 800)
        return "".join(parts)
    return simulate(num_loci=24, seed=89, name="dense").sequence


_JAX_BED: dict = {}


def _jax_distributed(name, chunk):
    """The JAX package's distributed_process_contig on the 8-device CPU
    mesh (one run per genome and chunk size)."""
    if (name, chunk) not in _JAX_BED:
        from ribbit_tpu.parallel.distributed import \
            distributed_process_contig as jax_dpc
        seq = _genome(name)
        _JAX_BED[name, chunk] = jax_dpc("chr", seq, JaxConfig.create(),
                                        chunk_size=chunk, n_devices=8)
    return _JAX_BED[name, chunk]


@pytest.mark.parametrize("name,chunk,devs,nchunks", [
    ("four-sims", 25_000, CPU8, 2),
    ("dense", 20_000, CPU8, 4),
    ("four-sims", 10_000, ["cpu"] * 3, 5),
    ("dense", 20_000, ["cpu", "cpu"], 4)],
    ids=["four-sims-8", "dense-8", "uneven-3-over-5", "repeated-cpu"])
def test_distributed_matches_jax_and_host_route(cpu_jax, name, chunk, devs,
                                                nchunks, monkeypatch):
    seq = _genome(name)
    cfg = RibbitConfig.create()
    calls = []
    real = distributed.scan_events_device
    monkeypatch.setattr(distributed, "scan_events_device",
                        lambda c, n, cfg_, device: calls.append(device)
                        or real(c, n, cfg_, device=device))
    got = distributed.distributed_process_contig("chr", seq, cfg,
                                                 chunk_size=chunk,
                                                 devices=devs)
    assert len(calls) == nchunks
    assert got == _jax_distributed(name, chunk)
    assert got == host.process_sequence("chr", seq, cfg)
    assert len(got) > 10


def test_distributed_one_chunk_takes_the_gpu_route(monkeypatch):
    """A contig of one chunk goes to pipeline.process_sequence on the first
    device, as the JAX package's goes to process_sequence."""
    seq = _genome("four-sims")
    cfg = RibbitConfig.create()
    seen = []
    real = pipeline.process_sequence
    monkeypatch.setattr(pipeline, "process_sequence",
                        lambda *a, **kw: seen.append(kw["device"])
                        or real(*a, **kw))
    got = distributed.distributed_process_contig(
        "chr", seq, cfg, chunk_size=len(seq), devices=["cpu"] * 4)
    assert seen == [torch.device("cpu")]
    assert got == host.process_sequence("chr", seq, cfg)


@pytest.mark.parametrize("entry", ["distributed", "multihost"])
def test_over_cap_contig_takes_the_over_cap_route(monkeypatch, capsys,
                                                  entry):
    """Past the native core's cap (lowered here to the contig's length) the
    contig goes to the port's announced over-cap route, never silently."""
    from ribbit_tpu_torch.parallel import multihost
    seq = _genome("four-sims")
    cfg = RibbitConfig.create()
    want = host.process_sequence("chr", seq, cfg)
    mod = distributed if entry == "distributed" else multihost
    monkeypatch.setattr(mod, "MAX_CONTIG", len(seq))
    capsys.readouterr()
    fn = (distributed.distributed_process_contig if entry == "distributed"
          else multihost.multihost_process_contig)
    assert fn("chr", seq, cfg, chunk_size=10_000, devices=CPU8) == want
    err = capsys.readouterr().err
    assert "replay unavailable" in err and "host's chunked path" in err


def test_multihost_without_a_group_is_distributed(monkeypatch):
    """One process (no group joined): multihost_process_contig is
    distributed_process_contig over the local devices."""
    seq = _genome("dense")
    cfg = RibbitConfig.create()
    seen = []
    real = distributed.scan_events_device
    monkeypatch.setattr(distributed, "scan_events_device",
                        lambda c, n, cfg_, device: seen.append(device)
                        or real(c, n, cfg_, device=device))
    got = multihost_process_contig("chr", seq, cfg, chunk_size=20_000,
                                   devices=["cpu", "cpu"])
    assert len(seen) == 4
    assert got == host.process_sequence("chr", seq, cfg)


def test_stack_windows_match_the_jax_package():
    from ribbit_tpu.parallel.distributed import _stack_windows as jax_sw
    from ribbit_tpu_torch.eventstitch import segment_bounds
    seq = _genome("dense")
    code, n_mask = encode(seq)
    bounds = segment_bounds(len(seq), 20_000)
    windows, chunks = distributed._stack_windows(code, n_mask, bounds)
    jwin, jcodes, jmasks, jlens, _lp = jax_sw(code, n_mask, bounds, 8)
    assert windows == jwin
    for k, (c, n) in enumerate(chunks):
        assert np.array_equal(c, jcodes[k, :jlens[k]])
        assert np.array_equal(n, jmasks[k, :jlens[k]])


# ---------------------------------------------------------------------------
# The split SSW forward (K3) and refinement against the JAX package
# ---------------------------------------------------------------------------

def _pairs():
    """tests/test_sharded_refine.py:8's 137 random pairs."""
    rng = np.random.default_rng(5)
    reads, refs, terms = [], [], []
    for i in range(137):                   # odd count: uneven blocks
        reads.append(rng.integers(0, 4, int(rng.integers(4, 120)))
                     .astype(np.int32))
        refs.append(rng.integers(0, 4, int(rng.integers(4, 160)))
                    .astype(np.int32))
        terms.append(int(rng.integers(10, 60)) if i % 3 == 0 else None)
    return reads, refs, terms


@pytest.mark.parametrize("devs", [CPU8, ["cpu"] * 3, ["cpu"] * 200],
                         ids=["8", "3", "more-devices-than-pairs"])
def test_split_forward_matches_pallas_k3(cpu_jax, devs, monkeypatch):
    from ribbit_tpu.align_pallas_v3 import batch_forward
    reads, refs, terms = _pairs()
    want = batch_forward(reads, refs, terms, interpret=True)
    sizes = []
    real = ak.ssw_forward_ref
    monkeypatch.setattr(ak, "ssw_forward_ref",
                        lambda p: sizes.append(p.n) or real(p))
    got = batch_forward_sharded([r.astype(np.uint8) for r in reads],
                                [f.astype(np.uint8) for f in refs], terms,
                                devices=devs)
    assert sizes == [len(b) for b in blocks(137, len(devs)) if len(b)]
    for g, w in zip(got, want):
        assert g.shape == (137,)
        assert np.array_equal(g, w)


def test_split_refinement_matches_oracle(golden_dir, monkeypatch):
    """refine_batched_sharded over 8 CPU devices reproduces g3's oracle BED
    byte for byte, with its forward batches of fits() pairs split in eight
    blocks and its oversized pairs in one batch."""
    calls = []
    real = ak.forward_pairs
    monkeypatch.setattr(ak, "forward_pairs",
                        lambda kernel, p, device:
                        calls.append((kernel.__name__, p.n))
                        or real(kernel, p, device))
    cfg = RibbitConfig.create()
    lines = []
    for sid, seq in read_fasta(str(golden_dir / "g3.fa")):
        code, n_mask = encode(seq)
        sess = CoreSession(code, n_mask, cfg)
        try:
            lines += refine_batched_sharded(sess.scan(), seq, sid, code,
                                            n_mask, sess, cfg, devices=CPU8)
        finally:
            sess.close()
    assert lines == (golden_dir / "g3.oracle.bed").read_text().splitlines()
    small = [n for k, n in calls if k == "ssw_forward_small"]
    large = [k for k, _n in calls].index("ssw_forward_large")
    assert small[:8] == [len(b) for b in blocks(sum(small[:8]), 8)]
    assert large == 8 and min(small[:8]) > 0
