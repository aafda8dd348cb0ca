"""Every configuration's algorithm resolves to an agent, a reference and a
work count that hold what the harness and traffic/learn.py call."""
import importlib
import json

import pytest

from bench_port import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_algorithm_files(cfg):
    algo = harness.load_json("configs", cfg["name"])["algo"]
    agent = importlib.import_module(f"bench_port.agents.{algo}")
    ref = importlib.import_module(f"bench_port.reference.{algo}")
    for f in ("build", "iteration_steps", "trees_added", "finite",
              "span_context", "phase_work", "readings"):
        assert callable(getattr(agent, f)), f
    assert all(len(s) == 3 for s in agent.SPANS)
    for f in ("inputs", "stand_in", "train_check", "serve_outputs"):
        assert callable(getattr(ref, f)), f
    assert (harness.HERE / "work" / f"{algo}.py").is_file()
