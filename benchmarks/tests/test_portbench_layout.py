"""Cells, configurations, traffic mixes and per-layer metrics are found by
name, and a new one of each needs new files and entries alone."""

import json
import re

import pytest

from conftest import ROOT

from harness import main, spec, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files():
    b = bench()
    assert b["command"] == ["python3", "benchmarks/run.py"]
    assert b["paths"] == ["benchmarks"]
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["records"] and cell.config["flags"]
        traffic.recipe(cell.config)         # raises on an unknown key
        assert cell.traffic["layout"] in ("one_fasta", "per_record")
        assert {m["name"] for m in cell.end_to_end} >= {"mbp_per_s",
                                                        "setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            reader = spec.metric_reader(m["name"])
            assert callable(reader.read)
            assert isinstance(reader.TARGETS, tuple)


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_config_and_metric_added_by_files_alone(tiny_root):
    """A dummy per-layer metric, written as a file and an entry, is read in
    a traced run of a dummy cell of a dummy configuration, and so are the
    program's phase metrics, whose entries name no cells and are the
    repository's as they stand."""
    (tiny_root / "benchmarks/metrics/dummy_scans.py").write_text(
        'TARGETS = ("core.CoreSession.scan",)\n\n'
        "def read(run):\n"
        "    n = sum(1 for s in run.spans if s[0] == TARGETS[0])\n"
        "    return float(n) if n else None\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "dummy_scans", "unit": "calls",
                           "better": "lower", "source": "program_span",
                           "layer": "core replay", "moves": "mbp_per_s",
                           "workloads": ["tiny.one"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    res, _ = main.run("tiny.one", 5, 0.5, True, device="cpu",
                      root=tiny_root, ref_workers=1, gen_workers=2)
    assert res["correct"]
    assert res["metrics"]["dummy_scans"]["value"] >= 1
    phases = ("extract_decode_s_per_mbp", "replay_anchored_s_per_mbp")
    ours = {m["name"]: m for m in bench()["per_layer"]}
    for name in phases:
        entry = next(m for m in b["per_layer"] if m["name"] == name)
        assert entry == ours[name] and "workloads" not in entry
    assert set(res["metrics"]) >= {"replay_s_per_mbp", "refine_s_per_mbp",
                                   *phases}


def test_unknown_workload_is_refused(tiny_root):
    with pytest.raises(SystemExit):
        spec.load_cell("nope.none", tiny_root)
