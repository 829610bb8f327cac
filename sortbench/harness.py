"""The benchmark's data-driven core: find a cell's files by name, run its
driver, read its per-layer metrics and assemble the result line.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names
``sortbench/configs/<config>.json`` and ``sortbench/traffic/<traffic>.json``;
the configuration's ``driver`` field names ``sortbench/drivers/<driver>.py``,
and each per-layer metric is ``sortbench/metrics/<name>.py``.  A later PR
adds a configuration, a traffic mix or a metric as new files and a new
entry of ``BENCHMARK.json``, and edits none of these.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

# top-level module names no process of a run may hold, compared whole
# (the port's name, repro_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(kind: str, name: str):
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    path = os.path.join(HERE, kind, f"{name}.py")
    mod_name = f"sortbench.{kind}.{name.replace('.', '__').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return _module("drivers", name)


def load_metric(name: str):
    return _module("metrics", name)


@dataclass
class Cell:
    """One entry of ``workloads`` with its files and its metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, int(w["chips"]), load_config(w["config"]), load_traffic(w["traffic"]),
                e2e, per_layer)


def derive(seed: int, *salt) -> int:
    """A 63-bit seed drawn from the run's seed and a label: the same seed
    and label always give the same number, distinct labels distinct ones."""
    h = hashlib.sha256(repr((int(seed),) + salt).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_keys(spec: dict, shape, dtype, gen, device):
    """Keys drawn on ``device`` from ``gen`` in one call: ``normal``
    (``scale``), ``uniform`` on [``low``, ``high``) or ``randint`` on
    [``low``, ``high``)."""
    import torch

    dist = spec["dist"]
    if dist == "normal":
        return (torch.randn(shape, generator=gen, device=device) * float(spec["scale"])).to(dtype)
    if dist == "uniform":
        lo, hi = float(spec["low"]), float(spec["high"])
        return (torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo).to(dtype)
    if dist == "randint":
        return torch.randint(int(spec["low"]), int(spec["high"]), shape, generator=gen,
                             device=device, dtype=dtype)
    raise ValueError(f"unknown key distribution {dist!r}")


def forbidden_modules() -> List[str]:
    """Modules in this process whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_info() -> dict:
    """The card's name and power limit by nvidia-smi ({} where it is absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": [line.strip() for line in out.splitlines() if line.strip()]}


class SmiSampler:
    """nvidia-smi's clocks, power draw and limit, sampled every half second
    beside a traced window (a no-op where nvidia-smi is absent)."""

    QUERY = "index,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"

    def __init__(self):
        self.proc = None

    def __enter__(self) -> "SmiSampler":
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader",
                 "-lms", "500"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc) -> None:
        self.lines = []
        if self.proc is not None:
            self.proc.terminate()
            out, _ = self.proc.communicate(timeout=30)
            self.lines = [line.strip() for line in out.splitlines() if line.strip()]


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and its device."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # host clock at process start
    info: Callable[[dict], None] = print
    rank: int = 0
    store: Optional[str] = None
    plans: Optional[str] = None  # the run's plan file
    hooks: tuple = ()  # "module:function"s applied in every process of the run


@dataclass
class Outcome:
    """What a driver hands back to the harness (rank 0's in a mesh)."""

    end_to_end: Dict[str, float]
    counters: Dict[str, Any]
    checks: Dict[str, tuple]  # name -> (value, limit): correct iff value <= limit
    attempted: int
    failed: int
    memory_peak_bytes: int
    chips: int
    trace: Any = None  # rank 0's Trace of the traced window
    busy_s: Optional[float] = None  # averaged over the chips used
    window_s: Optional[float] = None


@dataclass
class RunData:
    """What a per-layer metric's reader gets."""

    trace: Any
    counters: Dict[str, Any]


def device_section(outcome: Outcome, device: str) -> dict:
    import torch

    if device == "cuda":
        sec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:
        sec = {"platform": "cpu", "kind": "cpu"}
    sec.update(count=outcome.chips, memory_peak_bytes=int(outcome.memory_peak_bytes))
    if outcome.busy_s is not None:
        sec.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
    return sec


def assemble(ctx: Context, outcome: Outcome) -> dict:
    """The result line: end-to-end metrics untraced, per-layer traced."""
    metrics = {}
    if ctx.trace:
        data = RunData(outcome.trace, outcome.counters)
        for m in ctx.cell.per_layer:
            value = load_metric(m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in ctx.cell.end_to_end:
            if m["name"] in outcome.end_to_end:
                metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    correct = all(v <= lim for v, lim in outcome.checks.values())
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device_section(outcome, ctx.device)}
    if ctx.trace and outcome.trace is not None:
        result["breakdown"] = {"device_ops": outcome.trace.device_ops(),
                               "idle_gaps": outcome.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return result


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: Optional[float] = None, overrides: Optional[dict] = None,
             info: Callable[[dict], None] = print, **ctx_kw) -> Optional[dict]:
    """Run one cell once and return its result line (as a dict; None in a
    rank worker).

    ``overrides`` updates the configuration and the traffic
    (``{"config": {...}, "traffic": {...}}``): the tests' tiny CPU runs.
    Each of ``hooks`` names a function ``f(cell)`` that returns context
    managers entered around the run, in every process of it: the control
    and the planted faults that must make ``correct`` false.
    """
    cell = find_cell(name)
    for part in ("config", "traffic"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    ctx = Context(cell, int(seed), float(seconds), bool(trace), device,
                  time.perf_counter() if t_start is None else t_start, info, **ctx_kw)
    with ExitStack() as stack:
        for hook in ctx.hooks:
            mod, fn = hook.split(":")
            for cm in getattr(importlib.import_module(mod), fn)(cell):
                stack.enter_context(cm)
        outcome = load_driver(cell.config["driver"]).run(ctx)
    return None if outcome is None else assemble(ctx, outcome)


def print_checks(result: dict) -> None:
    """Each number compared, beside its limit, as the last lines of stderr."""
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct = {str(result['correct']).lower()}", file=sys.stderr, flush=True)


def worker_main(spec_json: str) -> int:
    """A rank worker of a multi-card cell: run the cell's driver as one rank.
    Returns the process's exit code."""
    spec = json.loads(spec_json)
    if spec["plans"]:
        os.environ["REPRO_SORT_PLANS"] = spec["plans"]
    run_cell(spec["workload"], spec["seed"], spec["seconds"], spec["trace"],
             device=spec["device"], overrides=spec["overrides"], rank=spec["rank"],
             store=spec["store"], plans=spec["plans"], hooks=tuple(spec["hooks"]))
    bad = forbidden_modules()
    if bad:
        print(f"sortbench rank {spec['rank']}: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0
