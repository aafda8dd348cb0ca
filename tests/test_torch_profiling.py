"""The port's spans and counters (gbrl_tpu_torch/utils/profiling.py) on the
CPU: nothing is recorded without a profiler, spans nest under a running
one, counts go to the innermost open span, the cap drops and counts,
records share the profiler's clock, and traced rehearsals of the
benchmark's cells give every reader of the program's spans and counters
something to read."""
import math
import os
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gbrl_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear()
    yield
    profiling.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(recs):
    return {r.name: r for r in recs}


def test_no_records_without_a_profiler():
    assert not profiling.recording()
    before = profiling.counters().get("test.off", 0)
    with profiling.span("outer", rows=3) as rec:
        profiling.count("test.off")
        profiling.tag(path="full")
    assert rec is None
    assert profiling.records() == []
    assert profiling.counters()["test.off"] == before + 1


def test_nested_spans_and_parents():
    with cpu_profile():
        assert profiling.recording()
        with profiling.span("outer", rows=3):
            with profiling.span("inner", d=0):
                pass
            with profiling.span("inner", d=1):
                profiling.tag(path="level")
        with profiling.span("second"):
            pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["inner", "inner", "outer", "second"]
    outer = recs[2]
    assert outer.parent is None and recs[3].parent is None
    assert [r.parent for r in recs[:2]] == [outer.id, outer.id]
    assert [r.attrs for r in recs[:2]] == [{"d": 0}, {"d": 1,
                                                      "path": "level"}]
    assert outer.attrs == {"rows": 3}
    assert len({r.id for r in recs}) == 4
    for r in recs[:2]:
        assert outer.t0 <= r.t0 <= r.t1 <= outer.t1
    # the profiler stopped: nothing more is recorded
    with profiling.span("after"):
        pass
    assert len(profiling.records()) == 4


def test_count_goes_to_the_innermost_open_span():
    with cpu_profile():
        with profiling.span("outer"):
            profiling.count("sync.a")
            with profiling.span("inner"):
                profiling.count("sync.b", 2)
            with profiling.span("sibling"):
                pass
    r = by_name(profiling.records())
    assert r["inner"].counts == {"sync.b": 2}
    assert r["sibling"].counts == {}
    assert r["outer"].counts == {"sync.a": 1, "sync.b": 2}


def test_count_sync_only_on_the_card():
    before = profiling.counters()
    profiling.count_sync("test_site", False)
    assert profiling.counters().get("sync.test_site") == \
        before.get("sync.test_site")
    profiling.count_sync("test_site", True, 6)
    assert profiling.counters()["sync.test_site"] == \
        before.get("sync.test_site", 0) + 6


def test_cap_drops_and_counts():
    rec = profiling.Recorder(cap=3)
    with cpu_profile():
        for i in range(5):
            with rec.span("s", i=i):
                pass
    assert [r.attrs["i"] for r in rec.records()] == [0, 1, 2]
    assert rec.dropped == 2
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0


def test_spans_share_the_profiler_clock():
    x = torch.ones(256, 256)
    with cpu_profile() as prof:
        with profiling.span("op"):
            y = torch.mm(x, x)
    assert y.shape == (256, 256)
    (rec,) = profiling.records()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert rec.t0 <= e.start_ns() <= e.start_ns() + e.duration_ns() \
            <= rec.t1


def test_spans_are_off_the_loops_when_not_recording():
    assert profiling.spanner()("mirror.forward", rows=4) is \
        profiling.span("predict")
    with cpu_profile():
        assert profiling.spanner() == profiling.span


NEW_METRICS = {
    "train": ("mirror_forward_ms", "minibatch_host_ms", "update_wait_ms",
              "counted_syncs_per_update"),
    "serve": ("predict_host_ms", "counted_syncs_per_request"),
}


def small_run(cell: str):
    r = harness.Run(cell, 2 ** 31 + 12345, 0.5, True, time.perf_counter(),
                    device="cpu")
    if r.mix["driver"] == "learn":
        r.cfg["total_timesteps"] = r.agent.iteration_steps(r.cfg)
    else:
        r.cfg["served_trees"] = 40
        r.mix["check_requests"] = 32
    return r


@pytest.mark.parametrize("cell", ["ppo_cartpole.train",
                                  "ppo_cartpole.serve"])
def test_traced_rehearsal_reads_every_program_metric(cell):
    r = small_run(cell)
    out = r.driver.run(r)
    metrics = out["metrics"]
    for name in NEW_METRICS[cell.split(".")[1]]:
        assert math.isfinite(metrics[name]["value"]), name
    assert profiling.dropped() == 0
    recs = profiling.records()
    ids = {x.id: x for x in recs}

    def path(x):
        names = []
        while x is not None:
            names.append(x.name)
            x = ids.get(x.parent)
        return names[::-1]
    if cell.endswith(".train"):
        assert metrics["minibatch_host_ms"]["value"] > 0
        # fit_launches_per_tree reads device operations: none on the CPU
        assert metrics.get("fit_launches_per_tree", {"value": 0.0}
                           )["value"] == 0.0
        paths = {tuple(path(x)) for x in recs}
        assert ("iteration", "update", "minibatch", "fit",
                "fit.level") in paths
        assert ("iteration", "rollout", "mirror.forward") in paths
        assert ("iteration", "mirror.sync") in paths
        for name in ("update.stage", "update.readback"):
            assert (("iteration", "update", name)) in paths
        syncs = [x for x in recs if x.name == "mirror.sync"
                 and ids[x.parent].name == "iteration"]
        assert syncs and all(x.attrs["trees"] == 32 for x in syncs)
    else:
        calls = [x for x in recs if x.name == "predict"]
        assert calls and all(x.parent is None for x in calls)
        assert all(x.attrs["path"] == "full" for x in calls)
        kids = {x.name for x in recs if x.parent is not None}
        assert kids == {"prepare", "cache_key", "n_trees", "ensemble_sum"}
