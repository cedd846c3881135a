"""Roofline accounting of the port's kernels on the card: the rates, the
operation counts and the measured int32 ceiling.

Counterpart of ribbit_tpu/bench_roofline.py (whose module imports jax).
chip_smoke.py and bench_device.py both take their bounds from here, so the
counts exist once.

  alu_probe  replaces the Pallas ALU probe (_alu_kernel): 8 chains x OPS x
             TRIPS int32 add/xor over an (8, 16384) tile, summed
             (csrc/alu_probe.cu).  alu_probe_ref is its plain version.
  probe_ceiling / int32_ceiling
             the card's int32 rate as the probe reaches it: the integer
             instructions of the probe's loop body, counted in its SASS
             (cuobjdump), times the iterations and threads that run them,
             over its time.  A compiler folds such chains, so a rate taken
             from the source's operation count could be impossible; a rate
             above 105% of spec_int32_rate raises.
  scan_work / probe_work
             the bytes and int32 operations of each kernel's function, from
             which chip_smoke.py's bounds and the roofline shares are taken.
  roofline   the shares of the memory rate and of the measured int32 rate
             that bench_device's kernel rates reach.

Each wrapper runs the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import pathlib
import re
import subprocess
import torch

from .backend import require_cuda
from .config import RibbitConfig
from .scan_events import OUT_ROWS, nsp_of

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
# lane instructions an SM can issue a clock: four partitions, each with a
# warp scheduler that dispatches 32 threads a clock (the SM diagram of
# NVIDIA's H100 architecture whitepaper); the data sheet's 67 TFLOP/s
# float32 rate counts the same 128 lanes (132 x 128 x 2 x 1.98 GHz).
# NVIDIA publishes no integer rate per SASS opcode, and the int32 probe
# issues its integer instructions faster than 64 a clock, so integer work
# is held against this issue limit: a floor on the time, never above it.
ISSUE_LANES_PER_SM = 128
# int32 operations per (position, row) that the scan passes need at least:
# the byte compare (anchor_planes, per shift row); the compare, the overlay
# OR and one operation for each of the two 8-windows (event_words, per
# plane row); those four and the run test (dense_masks, per motif row); the
# compare and one operation for the sliding window (eq_sum8, per shift row)
SCAN_OPS = {"anchor_planes": 1, "event_words": 4, "dense_masks": 5,
            "eq_sum8": 2}
# int32 issue slots per DP cell that SSW's recurrence needs at least: 7
# fused Hopper operations (DPX add-min for diag's add and clamp; max3 for
# h0, H and E; add-max for F's and E's gap steps; one max for the column
# max), the match score read from a query profile and the argmax taken per
# column, not per cell; every value is <= 32767, so the s16x2 forms take
# two cells to a 32-bit slot.  NVIDIA publishes no separate DPX rate: the
# slots are held against the int32 rate.
SSW_OPS_PER_CELL = 7 / 2
# the probe's tile and depth (ribbit_tpu/bench_roofline.py's ROWS, W, OPS,
# TRIPS): 8 x 16384 elements, 256 x 256 operations each, 8.59 G in all
ROWS, WIDTH = 8, 16384
OPS, TRIPS = 256, 256
CHAINS = 8
PROBE_REPS = 20
PROBE_LIMIT = 1.05             # refuse a probe rate above 105% of spec
CFG = RibbitConfig.create()    # the configuration the bench runs


def _smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return r.stdout.strip().splitlines()[0]


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def spec_int32_rate(device="cuda") -> float:
    """The card's int32 peak in operations/s: SMs x ISSUE_LANES_PER_SM x
    the maximum SM clock (nvidia-smi clocks.max.sm)."""
    require_cuda(device)
    mhz = float(_smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def bound(nbytes: float, ops: float, rate: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    int32 operations over the int32 rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def cuda_ms(fn, reps: int, consume=None) -> float:
    """Mean device time of fn() over reps runs (CUDA events around each
    run), after one warm-up.  consume(out), if given, reads each run's
    output after its end event, outside the time."""
    out = fn()
    if consume is not None:
        consume(out)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        if consume is not None:
            consume(out)
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def scan_work(kernel: str, L: int, cfg: RibbitConfig):
    """(bytes, int32 operations) of a scan pass over L bp: each input read
    once, each output written once, SCAN_OPS[kernel] per position and row.
    anchor_planes reads the code and writes one int32 word per 32
    positions and shift row; event_words and dense_masks read code, n_mask
    and those words and write 4 B per 8 plane rows, or 4 B (four int8
    planes) per motif row; eq_sum8 reads the code and writes two bytes
    (eq and sum8) per position and shift row."""
    anchors = cfg.nshifts * ((L + 31) // 32) * 4
    if kernel == "anchor_planes":
        return L + anchors, SCAN_OPS[kernel] * cfg.nshifts * L
    if kernel == "eq_sum8":
        return L + 2 * cfg.nshifts * L, SCAN_OPS[kernel] * cfg.nshifts * L
    rows = {"event_words": nsp_of(cfg), "dense_masks": cfg.nmotifs}[kernel]
    out = 4 * L * (rows // OUT_ROWS if kernel == "event_words" else rows)
    return 2 * L + anchors + out, SCAN_OPS[kernel] * rows * L


def probe_work(n: int = ROWS * WIDTH):
    """(bytes, int32 operations) of the probe's function on n elements at
    OPS x TRIPS: 4 B read and 4 B written each."""
    return 8 * n, OPS * TRIPS * n


# ---------------------------------------------------------------------------
# The int32 probe
# ---------------------------------------------------------------------------

def _check_probe(x: torch.Tensor, ops: int, trips: int):
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"alu_probe: want contiguous int32 [n], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if ops < 0 or ops % CHAINS or trips < 0 or (ops // CHAINS) * trips \
            >= 2**31:
        raise ValueError(f"alu_probe: ops {ops} (a multiple of {CHAINS}) "
                         f"and trips {trips} out of range")


def alu_probe_ref(x: torch.Tensor, ops: int, trips: int) -> torch.Tensor:
    """Plain version of alu_probe, one operation per chain at a time.  The
    chains run in int64: add and xor agree with int32 modulo 2**32, so the
    final wrap gives int32's result."""
    _check_probe(x, ops, trips)
    v = [x.to(torch.int64) + j for j in range(CHAINS)]
    for _ in range(trips):
        for _ in range(ops // CHAINS):
            for j in range(CHAINS):
                if j % 2 == 0:
                    v[j].add_(j)
                else:
                    v[j].bitwise_xor_(j + 17)
    acc = sum(v) & 0xFFFFFFFF
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/alu_probe.cu, built at first use (raises if nvcc fails)."""
    from .cuda_build import load
    lib = load("alu_probe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ribbit_alu_probe.restype = I
    lib.ribbit_alu_probe.argtypes = [P, I, I, I, P, I, P]
    lib.ribbit_alu_probe_unroll.restype = I
    lib.ribbit_alu_probe_unroll.argtypes = []
    return lib


def alu_probe(x: torch.Tensor, ops: int, trips: int) -> torch.Tensor:
    """int32 [n]: for each element, the sum of 8 chains from x + j after
    ops / 8 rounds in each of `trips` blocks (v += j on even chains,
    v ^= j + 17 on odd).  Kernel: ribbit_alu_probe."""
    _check_probe(x, ops, trips)
    if x.device.type == "cpu":
        return alu_probe_ref(x, ops, trips)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _lib()
    unroll = lib.ribbit_alu_probe_unroll()
    if (ops // CHAINS) * trips % unroll:
        raise ValueError(f"alu_probe: the kernel runs whole loop bodies of "
                         f"{unroll} rounds; ops / {CHAINS} x trips = "
                         f"{(ops // CHAINS) * trips} is not a multiple")
    out = torch.empty_like(x)
    rc = lib.ribbit_alu_probe(
        x.data_ptr(), x.numel(), ops // CHAINS, trips, out.data_ptr(),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"alu_probe: CUDA error {rc} at launch")
    alu_probe.launches += 1
    return out


alu_probe.launches = 0

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def sass_loop(sass: str) -> dict:
    """The longest loop of a kernel's SASS (the instructions from a
    backward branch's target up to the branch).  Counts its lane
    instructions, all but branches, NOPs and uniform-datapath (U*)
    instructions, which issue once a warp rather than once a lane, and
    each opcode among them."""
    insns, labels = [], {}
    pending = []
    for line in sass.splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        text = m.group(2).strip()
        words = text.split()
        op = words[1] if words[0].startswith("@") else words[0]
        insns.append((addr, op, text))
    best = None
    for addr, op, text in insns:
        if not op.startswith("BRA"):
            continue
        t = _TARGET.search(text)
        if not t:
            continue
        target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if target is None or target >= addr:
            continue
        body = [o.split(".")[0] for a, o, _ in insns if target <= a < addr]
        if best is None or len(body) > len(best):
            best = body
    if best is None:
        raise RuntimeError("sass_loop: no backward branch in the SASS")
    lane = [o for o in best if not o.startswith(("BRA", "NOP", "U"))]
    return {"instructions": len(lane),
            "opcodes": dict(collections.Counter(lane))}


def probe_sass() -> str:
    """cuobjdump -sass of the built probe library."""
    from .cuda_build import build, nvcc_path
    tool = pathlib.Path(nvcc_path()).parent / "cuobjdump"
    r = subprocess.run([str(tool), "-sass", str(build("alu_probe"))],
                       capture_output=True, text=True, timeout=120,
                       check=True)
    return r.stdout


def probe_ceiling(device="cuda") -> dict:
    """Times the probe at OPS x TRIPS on the (ROWS, WIDTH) tile and counts
    its SASS loop body: the integer instructions it issued per second
    (int32_tops).  Raises if that rate exceeds PROBE_LIMIT x
    spec_int32_rate."""
    require_cuda(device)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("probe_ceiling measures a card; got "
                         f"device {device}")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 100, (ROWS * WIDTH,), generator=g,
                      dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: alu_probe(x, OPS, TRIPS), PROBE_REPS,
                 consume=lambda o: o.sum())
    loop = sass_loop(probe_sass())
    unroll = _lib().ribbit_alu_probe_unroll()
    bodies = (OPS // CHAINS) * TRIPS // unroll * x.numel() / (ms / 1e3)
    spec = spec_int32_rate(device)
    rate = loop["instructions"] * bodies
    res = {"ms": ms, "source_ops": probe_work(x.numel())[1],
           "sass_loop_instructions": loop["instructions"],
           "sass_loop_opcodes": loop["opcodes"], "loop_rounds": unroll,
           "int32_tops": rate / 1e12, "spec_tops": spec / 1e12,
           "spec_frac": rate / spec}
    if rate > PROBE_LIMIT * spec:
        raise RuntimeError(f"the int32 probe's counted rate "
                           f"{rate / 1e12:.2f} Tops/s exceeds "
                           f"{PROBE_LIMIT:.0%} of the spec rate "
                           f"{spec / 1e12:.2f}: {res}")
    return res


def int32_ceiling(device="cuda") -> float:
    """The measured int32 rate, Tops/s (probe_ceiling)."""
    return probe_ceiling(device)["int32_tops"]


def roofline(kern: dict, L: int) -> dict:
    """Shares of the card's rates that bench_device's results at L bp
    reach: gpu_scan_hbm_frac and gpu_event_hbm_frac from the exact bytes
    of anchor_planes + dense_masks and anchor_planes + event_words
    (scan_work) over HBM_BYTES_PER_S; gpu_align_alu_frac from
    SSW_OPS_PER_CELL over the measured int32 rate (int32_alu_tops).  None
    where an input is None."""
    def per_bp(*kernels):
        return sum(scan_work(k, L, CFG)[0] for k in kernels) / L

    def frac(rate, per_unit, peak):
        return None if rate is None or peak is None else \
            rate * per_unit / peak

    mbps = lambda k: None if kern.get(k) is None else kern[k] * 1e6
    gcups = kern.get("gpu_align_gcups")
    alu = kern.get("int32_alu_tops")
    return {
        "gpu_scan_hbm_frac": frac(mbps("gpu_scan_mbps"),
                                  per_bp("anchor_planes", "dense_masks"),
                                  HBM_BYTES_PER_S),
        "gpu_event_hbm_frac": frac(mbps("gpu_event_mbps"),
                                   per_bp("anchor_planes", "event_words"),
                                   HBM_BYTES_PER_S),
        "gpu_align_alu_frac": frac(None if gcups is None else gcups * 1e9,
                                   SSW_OPS_PER_CELL,
                                   None if alu is None else alu * 1e12),
    }
