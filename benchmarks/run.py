"""Run one cell of the port's benchmark once:

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Prints the result as one JSON line, the last line of standard output.
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

_HERE = pathlib.Path(__file__).resolve().parent
sys.path[0:0] = [str(_HERE), str(_HERE.parent)]

if __name__ == "__main__":
    from harness.main import main
    sys.exit(main(t_script=T0))
