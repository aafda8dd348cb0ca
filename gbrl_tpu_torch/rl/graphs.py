"""The fused updates' steps as CUDA graphs: the one place that chooses
between a graph replay and a plain call (``run_step``), and the module
cache of the updates' graph sets (``cached_graphs``).

A fused update (``rl/jit_update.py`` ``_PPOGraphs``, ``rl/jit_awr.py``
``_AWRGraphs``) keeps its inputs in static device buffers that the host
refreshes once an update, and runs each step as a body that reads them
and counts device counters on.  On a CUDA device ``run_step`` captures a
body the first time its key comes and replays the graph after; on any
other device it calls the body.  Either way the update runs one body: the
CPU tests check the code the card replays.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import torch

from ..ops.kernels import launch_counts
from ..utils import profiling


def run_step(graphs: dict, key, dev: torch.device,
             body: Callable[[], None]) -> None:
    """One step of a fused update.  Off a CUDA device: ``body()``, and
    nothing is counted.  On one: replay ``graphs[key]``, or, the first
    time ``key`` comes, run ``body`` on a side stream (the warm-up a
    capture needs) and then capture it into ``graphs[key]``.  A capture's
    counts (``launch.<kernel>``) are held back and credited at each
    replay, as are ``launch_counts``; ``graph.replay``, ``graph.eager``
    and ``graph.capture`` count what ran."""
    if dev.type != "cuda":
        body()
        return
    entry = graphs.get(key)
    if entry is not None:
        graph, counted = entry
        graph.replay()
        for name, n in counted.items():
            profiling.count(name, n)
            if name.startswith("launch."):
                launch_counts[name[len("launch."):]] += n
        profiling.count("graph.replay")
        return
    stream = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        body()
    stream.wait_stream(side)
    profiling.count("graph.eager")
    graph = torch.cuda.CUDAGraph()
    before = dict(launch_counts)
    with profiling.collect() as counted, torch.cuda.graph(graph):
        body()
    launch_counts.update(before)
    graphs[key] = (graph, counted)
    profiling.count("graph.capture")


# the graph sets by everything a capture bakes in, the device among it
# (never by a learner or an ensemble), PPO's and AWR's; the oldest goes
# past GRAPH_CACHE; CPU sets (buffers, no graphs) share the slots
GRAPH_CACHE = 8
_GRAPHS: "OrderedDict[tuple, object]" = OrderedDict()


def cached_graphs(key: tuple, make: Callable[[], object]):
    """The graph set of ``key``, made by ``make`` the first time."""
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = make()
        if len(_GRAPHS) > GRAPH_CACHE:
            _GRAPHS.popitem(last=False)
    return g
