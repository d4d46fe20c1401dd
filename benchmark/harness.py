"""One run of one cell: set-up, the measured window, the traced window,
the per-layer readers, the check, the result line.

Everything a cell is made of is found by name, under the checkout's
root (``BENCHMARK.json`` there):

* ``benchmark/configs/<config>.json``: the model configuration;
* ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters,
  whose ``kind`` names the loop in ``benchmark/loops/<kind>.py``;
* ``benchmark/limits/<cell>.json``: the limit of each number the
  cell's check compares;
* ``benchmark/metrics/<metric>.py``: each per-layer metric's reader,
  ``read(run) -> float | None``.

A loop module gives ``setup(run)``, ``window(run, seconds) -> {metric:
value}`` (which sets ``run.window_s`` and ``run.window_requests``: the
calls or steps in it), ``traced(run, seconds) -> requests``,
``release(run)`` (frees the program's state, keeps its outputs) and
``check(run) -> {number: (value, limit)}``; ``run.attempted`` and
``run.failed`` count its requests.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "segtpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def metrics_of(man: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    that list it, or list no cells and move (or are) a metric it reports."""
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """The state of one run, which the loop and the readers share."""

    def __init__(self, man: dict, workload: str, seed: int, device,
                 overrides: Optional[dict] = None, root: Path = ROOT):
        cells = {w["name"]: w for w in man["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.man = man
        self.cell = cells[workload]
        self.seed = int(seed)
        self.device = torch.device(device)
        configs = {c["name"]: c for c in man["configs"]}
        self.cfg = load_json(root / configs[self.cell["config"]]["file"])
        self.bench = root / "benchmark"
        self.traffic = load_json(self.bench / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.traffic.update(overrides or {})
        self.limits = load_json(self.bench / "limits" / f"{workload}.json")
        self.loop = load_module(
            self.bench / "loops" / f"{self.traffic['kind']}.py",
            f"benchmark_loop_{self.traffic['kind']}")
        self.attempted = 0
        self.failed = 0
        self.notes: Dict[str, object] = {}
        self.window_result: Dict[str, float] = {}
        self.trace: Optional[dict] = None

    def note(self, **kw):
        """Earlier lines of output: set-up's parts, the generator's
        lateness, the window's counts."""
        self.notes.update(kw)
        print("# " + json.dumps(kw, default=float), file=sys.stderr,
              flush=True)

    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda():
            torch.cuda.synchronize(self.device)


def read_per_layer(run: Run, entries: list) -> Dict[str, dict]:
    out = {}
    for m in entries:
        reader = load_module(run.bench / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            device="cuda", overrides: Optional[dict] = None,
            t_start: Optional[float] = None, root: Path = ROOT) -> dict:
    """One run; returns the result object (the last line's)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest(root)
    run = Run(man, workload, seed, device, overrides, root)
    run.note(imports_s=time.perf_counter() - t_start)
    run.loop.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    run.note(setup_s=setup_s)
    run.window_result = run.loop.window(run, seconds)
    peak = (torch.cuda.max_memory_allocated(run.device) if run.cuda()
            else 0)
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if run.cuda() else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device)
                            if run.cuda() else "cpu"),
                   "count": int(run.cell["chips"]) if run.cuda() else 0,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from benchmark.trace import Trace
        seconds_traced = float(run.traffic["trace_seconds"])
        with Trace(run.device) as tr:
            done = run.loop.traced(run, seconds_traced)
        run.trace = tr.summary()
        run.note(traced_requests=done, traced_s=run.trace["window_s"],
                 traced_ms_per_request=1e3 * run.trace["window_s"] / done,
                 window_ms_per_request=1e3 * run.window_s / run.window_requests)
        with Trace(run.device, host=True) as named:
            run.loop.traced(run, seconds_traced)
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        breakdown = Trace.breakdown(run.trace, named.gaps())
        metrics = read_per_layer(run, metrics_of(man, workload, "per_layer"))
    else:
        for m in metrics_of(man, workload, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" \
                else run.window_result[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    run.loop.release(run)
    run.sync()
    checks = run.loop.check(run)
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def print_checks(result: dict):
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr, flush=True)
