"""Fixtures of the benchmark's own tests (CPU here; the `card` marker's
tests run only where a CUDA device is, and skip elsewhere).

Run them from the repository root:

    python -m pytest benchmarks/tests -q
"""

import json
import pathlib
import shutil
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


TINY_CONFIG = {"flags": {"min_motif": 2, "max_motif": 100},
               "n_block_rate": 0.1,
               "records": [{"name": "a", "length": 60000},
                           {"name": "b", "length": 50000}]}
TINY_RECIPE = {**TINY_CONFIG, "recipe": {"motif_bp": [2, 60]}}
TINY_TRAFFIC = {
    "one": {"layout": "one_fasta", "warmup": {"length": 20000},
            "pass_bp": 600000,
            "check": {"records": 1, "from": [1, 2], "prefix_bp": 20000}},
    "jobs": {"layout": "per_record", "warmup": {"record": "b"},
             "pass_bp": 600000,
             "check": {"records": 2, "from": [1, 3], "prefix_bp": 20000}},
}


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout-shaped directory with the repository's BENCHMARK.json
    metrics and readers, two tiny cells of one tiny configuration and one
    of a tiny configuration with a recipe, added by files and entries
    alone."""
    (tmp / "benchmarks").mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", tmp / "benchmarks" / "metrics")
    (tmp / "benchmarks" / "configs").mkdir()
    (tmp / "benchmarks" / "traffic").mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config, obj in (("tiny", TINY_CONFIG), ("tiny_recipe", TINY_RECIPE)):
        bench["configs"].append({"name": config, "source": "test",
                                 "file": f"benchmarks/configs/{config}.json",
                                 "reduced": [], "why": "test"})
        (tmp / f"benchmarks/configs/{config}.json").write_text(
            json.dumps(obj))
    for name, t in TINY_TRAFFIC.items():
        (tmp / f"benchmarks/traffic/{name}.json").write_text(json.dumps(t))
        bench["workloads"].append({"name": f"tiny.{name}", "config": "tiny",
                                   "traffic": name, "chips": 1,
                                   "why": "test"})
    bench["workloads"].append({"name": "tiny_recipe.jobs",
                               "config": "tiny_recipe", "traffic": "jobs",
                               "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.one")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def small_segments(monkeypatch, seg: int = 40000):
    """Cut the port's extraction segment so that the tiny records take
    two segments and are stitched, as a chromosome is."""
    from ribbit_tpu_torch import pipeline
    orig = pipeline.extract_events

    def extract(code, n_mask, cfg, device="cuda", seg_size=seg):
        return orig(code, n_mask, cfg, device, seg)
    monkeypatch.setattr(pipeline, "extract_events", extract)
