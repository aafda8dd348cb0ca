"""One run of one cell: finds the cell's files by name, checks the device,
hands the run to its traffic driver, and prints the result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Files found by name (later changes add files, and edit none):
  workloads/<cell>.json   the cell: its configuration, its traffic mix and
                          the limits of its check;
  configs/<config>.json   the model configuration: sizes, hyperparameters,
                          the algorithm and env it names;
  traffic/<mix>.json      the traffic mix: its driver and its parameters;
  traffic/<driver>.py     the driver: set-up, the measured window, the check;
  agents/<algo>.py        the program side of an algorithm;
  reference/<algo>.py     the plain reference of an algorithm;
  metrics/<metric>.py     the reader of one per-layer metric.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "gbrl_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prepare_environment() -> None:
    """The program's kernel and mirror builds go to one fixed directory of
    the checkout, so the first run of a cell builds them and later runs
    load them; a few host threads keep the runs steady."""
    os.environ["GBRL_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build" / "bench_port")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``gbrl_tpu_torch`` is not ``gbrl_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """Everything a traffic driver needs for one run."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda"):
        self.cell = cell
        self.workload = load_json("workloads", cell)
        self.cfg = load_json("configs", self.workload["config"])
        self.mix = load_json("traffic", self.workload["traffic"])
        self.limits = self.workload["limits"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t_start = t_start
        self.device = device
        algo = self.cfg["algo"]
        self.agent = importlib.import_module(f"bench_port.agents.{algo}")
        self.reference = importlib.import_module(f"bench_port.reference.{algo}")
        self.driver = importlib.import_module(
            f"bench_port.traffic.{self.mix['driver']}")

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def per_layer(self, trace) -> dict:
        """Every per-layer metric that names this cell, from its reader;
        a reader that finds nothing returns None and the metric is left
        out."""
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        out = {}
        for m in bench["per_layer"]:
            if self.cell not in m.get("workloads", [self.cell]):
                continue
            reader = load_file(HERE / "metrics" / f"{m['name']}.py")
            v = reader.read(trace, self)
            if v is not None and math.isfinite(v):
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out


def check_device(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark measures the card "
                         "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} devices, "
                         f"{torch.cuda.device_count()} found")


def cell_chips(cell: str) -> int:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == cell:
            return int(w["chips"])
    raise BenchError(f"no cell named {cell!r} in BENCHMARK.json")


def check_program_source() -> None:
    """The program under test is this checkout's, never an installed
    copy."""
    import gbrl_tpu_torch
    where = Path(gbrl_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise BenchError(f"gbrl_tpu_torch loaded from {where}, not from the "
                         f"checkout {ROOT}")


def judge(run: Run, numbers: dict, failed: int):
    """(correct, the numbers beside their limits)."""
    checks = {}
    ok = failed == 0
    for name, value in numbers.items():
        limit = run.limits[name]
        passed = value is not None and math.isfinite(value) and value <= limit
        ok = ok and passed
        # a number that is not finite (no answer came) prints as null
        checks[name] = {"value": value if passed or (
            value is not None and math.isfinite(value)) else None,
            "limit": limit}
    return ok, checks


def main(args, t_start: float) -> int:
    prepare_environment()
    try:
        chips = cell_chips(args.workload)
        run = Run(args.workload, args.seed, args.seconds, args.trace, t_start)
        check_device(chips)
        check_program_source()
        out = run.driver.run(run)
    except BenchError as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: modules of JAX or the JAX package are loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    import torch
    result = result_line(run, out, chips, torch.cuda.get_device_name(0))
    gc.collect()
    for name, c in result["checks"].items():
        run.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def result_line(run: Run, out: dict, chips: int, kind: str) -> dict:
    """The result: correct, attempted, failed, metrics, device (and the
    traced run's breakdown), then the numbers compared beside their
    limits, last."""
    correct, checks = judge(run, out["numbers"], out["failed"])
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if run.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result
