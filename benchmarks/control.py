"""The control of the benchmark's correctness check: the plain reference
put in the program's place with its purity arithmetic one precision below
the configuration's (float16 for C++ float), run through a whole cell run
(a short window at the cell's own load, then the check).  Its
bed_mismatch has to come out above 0, so `correct` false:

    python3 benchmarks/control.py --workload <name> --seed <n> [--seconds 5]

It prints the checks' JSON line; the benchmark's own runs never run it.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

_HERE = pathlib.Path(__file__).resolve().parent
sys.path[0:0] = [str(_HERE), str(_HERE.parent)]


def float16_lines(rec, seq, dig, lines, ref_cfg, prefix_bp, workers):
    """(digests, lines) of the control: the reference's lines of the
    record's checked part at float16 purity, and the timed path's event
    digests."""
    import os

    import numpy as np
    from harness.check import PAD
    from ribbitref import cigarproc, engine
    hi = min(len(seq), prefix_bp + PAD)
    cigarproc.FLOAT = np.float16
    try:
        return dig, engine.process_sequence(
            rec.name, seq[:hi], ref_cfg,
            workers=workers or os.cpu_count() or 1)
    finally:
        cigarproc.FLOAT = np.float32


def main(argv=None) -> int:
    import argparse
    from harness import main as harness_main
    p = argparse.ArgumentParser(description="the check's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    res, lines = harness_main.run(a.workload, a.seed, a.seconds, False,
                                  t_script=T0, control=float16_lines)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "correct": res["correct"], "checks": res["checks"],
                      "detail": res["check_detail"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
