"""The benchmark's driver-independent part: find a cell by name in
BENCHMARK.json, load its configuration and traffic files, hand a Run to
the loop its traffic names (portbench/drivers/<loop>.py), read its
metrics (portbench/metrics/<name>.py) and print the result line.

Nothing here knows a cell, a configuration or a metric by name: a later
cell, mix or metric is a new file plus an entry in BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

from . import hostprobe

# top-level module names no run may hold once its window has closed: the
# JAX stack and the JAX package the port was made from (compared whole, so
# the port, coreth_tpu_torch, is not among them)
FORBIDDEN = ("jax", "jaxlib", "flax", "coreth_tpu")


class BenchmarkError(Exception):
    """BENCHMARK.json or a file it names is not what the harness needs."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, tag: str):
    """Import the Python file at `path` under a private module name."""
    if not os.path.exists(path):
        raise BenchmarkError(f"no file {path}")
    name = "portbench_" + tag + "_" + re.sub(r"[^A-Za-z0-9_]", "_",
                                             os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    """A metric with no `workloads` key is reported in every cell."""
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    """One entry of `workloads` with everything it names, loaded."""

    def __init__(self, root: str, name: str, bench: dict = None):
        self.root = root
        self.bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json "
                                 f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            root, "portbench", "traffic", self.entry["traffic"] + ".json"))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if applies(m, name)]

    def path(self, *parts) -> str:
        return os.path.join(self.root, "portbench", *parts)


class GcPauses:
    """Host time the garbage collector paused the process while open."""

    def __init__(self):
        self.ms = 0.0
        self.count = 0
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.count += 1

    def start(self):
        gc.callbacks.append(self._cb)

    def stop(self):
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)


class Run:
    """What a loop needs from the harness, and what it hands back.

    A loop (portbench/drivers/<loop>.py, `run(run)`) does its set-up,
    calls window_open(), runs its window (after_block() after each
    block), calls window_close(), frees the program's state, and compares
    with the reference through check(). It fills `e2e` with the cell's
    end-to-end metrics, `series` with per-block host readings, `objects`
    with the live program objects the metrics' samplers read, `notes`
    with counts the readers need, and `attempted` / `failed`."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 t_start: float, device, control: bool = False,
                 log=None):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.control = bool(control)
        self.t_start = t_start
        self.device = device
        self.series = defaultdict(list)
        self.samples = defaultdict(list)
        self.objects = {}
        self.notes = {}
        self.e2e = {}
        self.checks = {}
        self.attempted = 0
        self.failed = 0
        self.profile = None
        self.gc = GcPauses()
        self.setup_s = None
        self.memory_peak = 0
        self.forbidden = []
        self._log = log or (lambda msg: print(msg, flush=True))
        self.readers = {}
        if self.trace:
            for m in cell.per_layer:
                self.readers[m["name"]] = load_module(
                    cell.path("metrics", m["name"] + ".py"), "metric")

    def log(self, msg: str) -> None:
        self._log(msg)

    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda():
            import torch

            torch.cuda.synchronize(self.device)

    def window_open(self) -> float:
        """Marks the end of set-up; returns the window's start (host
        clock)."""
        self.sync()
        self.log(hostprobe.line("at the window's start", hostprobe.probe()))
        t = time.perf_counter()
        self.setup_s = t - self.t_start
        if self.trace:
            self.gc.start()
        return t

    def after_block(self) -> None:
        """In a traced run, each metric's sampler reads the block just
        done."""
        if not self.trace:
            return
        for name, mod in self.readers.items():
            fn = getattr(mod, "sample", None)
            if fn is not None:
                v = fn(self)
                if v is not None:
                    self.samples[name].append(v)

    def window_close(self) -> None:
        """After the window: the device memory peak and the modules
        loaded, before the reference runs."""
        self.sync()
        self.gc.stop()
        if self.cuda():
            import torch

            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
        self.forbidden = forbidden_loaded()
        self.log(hostprobe.line("after the window", hostprobe.probe()))
        if self.profile is not None:
            if not self.profile.stopped:
                self.profile.end()
            self.profile.reduce()

    def check(self, name: str, value, limit) -> None:
        """A number compared with its limit: the run is correct only if
        every number is at most its limit."""
        self.checks[name] = (value, limit)

    def profile_begin(self, lead_in) -> None:
        """Open the profiled interval (traced runs only); `lead_in()`
        launches kernels that soak up the trace's dropped prefix."""
        if self.trace:
            from .profile import Interval

            self.profile = Interval(self.device, lead_in, self.log)
            self.profile.begin()

    def profile_end(self) -> None:
        """Close the profiled interval; the collector's pauses while the
        profiler stops are not the program's."""
        if self.profile is not None and not self.profile.stopped:
            self.gc.stop()
            self.profile.end()
            self.gc.start()


def forbidden_loaded() -> list:
    """The forbidden top-level names that sys.modules holds."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        out.stderr.strip() or "nvidia-smi printed nothing")


def result(run: Run) -> dict:
    """The result line's object."""
    cell = run.cell
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            v = run.readers[m["name"]].read(run)
            if v is None:
                run.log(f"metric {m['name']}: nothing to read; left out")
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise BenchmarkError(f"the loop gave no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if run.cuda() else "cpu",
              "kind": run.device_kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak,
              "power_limit": run.power_limit}
    out = {"correct": all(v <= lim for v, lim in run.checks.values())
           and bool(run.checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.profile is not None and run.profile.done:
        p = run.profile
        device["busy_s"] = p.busy_s
        device["window_s"] = p.window_s
        out["breakdown"] = {"device_ops": p.top_ops(10),
                            "idle_gaps": p.top_gaps(10)}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def execute(root: str, workload: str, seed: int, seconds: float,
            trace: bool, device, t_start: float = None, control=False,
            bench: dict = None, config_overrides: dict = None,
            traffic_overrides: dict = None, log=None) -> dict:
    """Run one cell once and return its result object. The tests call this
    on the CPU with smaller sizes (`*_overrides`); main() on the card."""
    cell = Cell(root, workload, bench)
    cell.config.update(config_overrides or {})
    cell.traffic.update(traffic_overrides or {})
    run = Run(cell, seed, seconds, trace,
              t_start if t_start is not None else time.perf_counter(),
              device, control=control, log=log)
    if run.cuda():
        import torch

        run.device_kind = torch.cuda.get_device_name(device)
        run.power_limit = _nvidia_smi()
    else:
        run.device_kind, run.power_limit = "cpu", "none"
    run.log(hostprobe.line("at set-up's start", hostprobe.probe()))
    loop = load_module(cell.path("drivers", cell.traffic["loop"] + ".py"),
                       "driver")
    loop.run(run)
    if run.forbidden:
        raise BenchmarkError("modules loaded by the window: "
                             + ", ".join(run.forbidden))
    out = result(run)
    # again once the reference, the comparison and every reader have run
    late = forbidden_loaded()
    if late:
        raise BenchmarkError("modules loaded after the window: "
                             + ", ".join(late))
    return out


def main(argv, t_start: float, root: str) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the cell's control in the program's place "
                    "(PERF.md: how correct is decided); not a measurement")
    args = ap.parse_args(argv)
    try:
        cell = Cell(root, args.workload)
    except (BenchmarkError, OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        out = execute(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start,
                      control=bool(args.control), bench=cell.bench)
    except BenchmarkError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
