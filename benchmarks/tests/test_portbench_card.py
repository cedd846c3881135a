"""One short run of every cell on the card through BENCHMARK.json's
command: a result line that is correct and has the result's keys.  Skips
without a CUDA device; on a machine with one:

    python -m pytest benchmarks/tests/test_portbench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    r = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        workload, "--seed", "2147483659", "--seconds", "5",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=1200, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert {"mbp_per_s", "setup_s", "host_peak_gib"} <= set(res["metrics"])
