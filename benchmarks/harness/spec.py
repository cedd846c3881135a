"""The cell a run measures, found by name: its entry in BENCHMARK.json,
its configuration file, its traffic file and the reader file of each
per-layer metric.  Adding a cell, a configuration, a traffic mix or a
per-layer metric takes new files and new entries, no edit here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's object
    traffic: dict         # the traffic file's object
    end_to_end: list      # BENCHMARK.json entries that this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic_file = root / "benchmarks" / "traffic" / f"{w['traffic']}.json"
    traffic = json.loads(traffic_file.read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)])


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The module of benchmarks/metrics/<name>.py: TARGETS (the program's
    attributes whose calls it reads, as spans) and read(run) -> float or
    None."""
    path = root / "benchmarks" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
