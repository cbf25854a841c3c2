"""One run of one cell: arguments, environment, the card, the driver of the
cell's path, and the result line.

The cell (``--workload``) is looked up in ``BENCHMARK.json`` at the root of
the checkout; its configuration, traffic mix and limits are files found by
name, and each per-layer metric is read by ``metrics/<name>.py``. The
traffic mix names its ``kind``, the driver (``drivers/<kind>.py``) that
builds the port's path, warms it, runs the measured window, frees the
program's state and compares what the window produced with the plain
reference (``check.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".portbench_cache")
# the JAX side of the repo: nothing the benchmark runs may load it
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ruart_tpu")
T_IMPORT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def set_environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a
    library."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell and its files, the run's arguments."""

    workload: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    setup_start_s: float = 0.0   # process age when the run began
    # None; or the control put in the program's place (control.py)
    control: Optional[str] = None

    def setup_s(self) -> float:
        return process_age_s() - self.setup_start_s


@dataclasses.dataclass
class Outcome:
    """What a driver hands back. ``e2e``: end-to-end values by name;
    ``record``: what the per-layer readers read; ``compared``: {name:
    (value, limit)}, every number that decides ``correct``."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    record: Dict[str, Any]
    compared: Dict[str, tuple]
    memory_peak_bytes: int
    trace: Optional[Dict[str, Any]] = None
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and self.attempted > 0 and all(
            v == v and v <= lim for v, lim in self.compared.values())


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: Dict[str, Any], name: str,
         declared: bool = True) -> Dict[str, Any]:
    """The cell ``name`` of ``BENCHMARK.json``; with ``declared`` False
    also a cell named ``<config>.<mix>`` from files alone (the tools and
    tests run cells a benchmark has not declared yet)."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    config, _, mix = name.partition(".")
    if not declared and all(os.path.exists(os.path.join(HERE, kind, f + ".json"))
                            for kind, f in (("configs", config), ("traffic", mix))):
        return {"name": name, "config": config, "traffic": mix, "chips": 1}
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave no answer"


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_run(args, bench, device, setup_start_s, declared=True) -> Run:
    from portbench.build import read_json

    w = cell(bench, args.workload, declared)
    limits_path = os.path.join(HERE, "limits", f"{args.workload}.json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)
    return Run(args.workload, read_json("configs", w["config"]),
               read_json("traffic", w["traffic"]), limits, args.seed,
               args.seconds, bool(args.trace), device, setup_start_s)


def execute(run: Run) -> Outcome:
    kind = run.traffic["kind"]
    driver = importlib.import_module(f"portbench.drivers.{kind}")
    return driver.run(run)


def result(run: Run, bench, out: Outcome, device_info) -> Dict[str, Any]:
    metrics: Dict[str, Any] = {}
    if not run.trace:
        for m in bench["end_to_end"]:
            if applies(m, run.workload) and m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not applies(m, run.workload):
                continue
            value = reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=int(out.memory_peak_bytes))
    line: Dict[str, Any] = {
        "correct": out.correct, "attempted": out.attempted,
        "failed": out.failed, "metrics": metrics, "device": device,
    }
    if run.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        line["breakdown"] = out.trace["breakdown"]
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.compared.items()}
    return line


def main(argv=None) -> int:
    setup_start = process_age_s()
    args = parse(argv)
    set_environment()
    bench = benchmark()
    chips = int(cell(bench, args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    device = torch.device("cuda", 0)
    run = make_run(args, bench, device, setup_start)
    out = execute(run)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: the process holds {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    line = result(run, bench, out, info)
    if out.notes:
        print(f"notes {json.dumps(out.notes)}", file=sys.stderr)
    for k, (v, lim) in out.compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def local(workload: str, seed: int, seconds: float, device="cpu",
          config: Optional[Dict[str, Any]] = None,
          traffic: Optional[Dict[str, Any]] = None,
          limits: Optional[Dict[str, Any]] = None, trace: bool = False,
          root: str = ROOT, control: Optional[str] = None):
    """A run without the look for a card, on ``device``, with the cell's
    files replaced where given (tests run tiny configurations on the CPU
    this way). Returns (result line, outcome)."""
    import torch

    bench = benchmark(root)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=int(trace))
    run = make_run(args, bench, torch.device(device), process_age_s(),
                   declared=False)
    if config is not None:
        run.config = config
    if traffic is not None:
        run.traffic = traffic
    if limits is not None:
        run.limits = limits
    run.control = control
    out = execute(run)
    info = {"platform": torch.device(device).type, "kind": str(device),
            "count": 1}
    return result(run, bench, out, info), out
