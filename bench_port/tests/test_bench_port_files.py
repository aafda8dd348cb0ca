"""Every configuration, cell, traffic mix and metric that BENCHMARK.json
names resolves to its files by name, and the files hold what the harness
reads."""
import json
import os

import pytest

from bench_port import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert (harness.ROOT / data["reference"]).is_file()
    assert harness.load_json("configs", cfg["name"]) == data


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    r = harness.Run(cell["name"], 1, 1.0, False, 0.0, device="cpu")
    assert r.workload["config"] == cell["config"]
    assert r.workload["traffic"] == cell["traffic"]
    assert callable(r.driver.run)
    assert callable(r.reference.serve_outputs)
    assert set(r.limits) >= {"output_gap"} or set(r.limits) >= {
        "loss_gap", "grad_gap", "change_gap", "forward_gap"}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    reader = harness.load_file(harness.HERE / "metrics"
                               / f"{metric['name']}.py")
    assert callable(reader.read)
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric["workloads"]) <= names
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_paths_hold_the_command():
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"][1].startswith("bench_port/")
    assert os.path.isfile(harness.ROOT / BENCH["command"][1])
