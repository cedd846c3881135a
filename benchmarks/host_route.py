"""The yardstick beside the benchmark: one run of a cell through the port's
host route (`--backend host`, the C core alone) in place of the card's,
same files, same window, same check (its events are not compared):

    python3 benchmarks/host_route.py --workload <name> --seed <n> \
        [--seconds 30]

Prints the result's JSON line; its numbers go to PERF.md, not to a metric.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

_HERE = pathlib.Path(__file__).resolve().parent
sys.path[0:0] = [str(_HERE), str(_HERE.parent)]


def main(argv=None) -> int:
    import argparse
    from harness import main as harness_main
    p = argparse.ArgumentParser(description="a cell on the host route")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    a = p.parse_args(argv)
    res, lines = harness_main.run(a.workload, a.seed, a.seconds, False,
                                  t_script=T0, backend="host")
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps({"route": "host", "workload": a.workload, **res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
