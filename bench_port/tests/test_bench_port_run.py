"""A run as the harness makes it, on the CPU: the result line's keys, the
latency statistic over every request, and a run without a card fails."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from bench_port import harness

ROOT = str(harness.ROOT)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_run(cell: str, seconds: float = 0.5, trace: bool = False):
    r = harness.Run(cell, 2 ** 31 + 12345, seconds, trace, time.perf_counter(),
                    device="cpu")
    if r.mix["driver"] == "learn":
        r.cfg["total_timesteps"] = 3 * r.agent.iteration_steps(r.cfg)
    else:
        r.cfg["served_trees"] = 40
        r.mix["check_requests"] = 32
    return r


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    r = small_run("ppo_cartpole.serve", trace=trace)
    out = r.driver.run(r)
    res = harness.result_line(r, out, 1, "cpu")
    keys = list(res)
    assert keys[:5] == KEYS
    assert keys[-1] == "checks"
    assert keys[5:-1] == (["breakdown"] if trace else [])
    assert set(res["checks"]) == set(r.limits)
    assert res["correct"] is True
    json.loads(json.dumps(res))
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"act_p95_ms", "setup_s"}


def test_p95_over_every_request(monkeypatch):
    """Every tenth request is slow: the 95th percentile of all requests
    lies among the slow ones; with one in twenty-five slow it does not."""
    for every, slow in ((10, True), (25, False)):
        calls = []

        def serving_model(cfg, arrays, directory, device):
            def call(obs):
                calls.append(len(obs))
                if len(calls) % every == 0:
                    time.sleep(0.004)
                return (np.zeros((len(obs), 2)), np.zeros(len(obs)))
            return call
        r = small_run("ppo_cartpole.serve", seconds=0.6)
        monkeypatch.setattr(r.agent, "serving_model", serving_model)
        out = r.driver.run(r)
        warm = len(calls) - out["attempted"]
        assert warm == r.mix["warmup_requests"]
        assert set(calls) == {r.cfg["n_envs"]}
        p95 = out["metrics"]["act_p95_ms"]["value"]
        assert (p95 >= 4.0) == slow, (every, p95)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "ppo_cartpole.serve", "--seed", "5", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
