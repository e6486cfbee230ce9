"""One run of one cell: set-up, the measured window, the traced stretch,
the checks, and the result line."""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from bench.harness import cells, trace

#: top-level module names that may not be loaded in a run: JAX, and the
#: JAX package and its benchmarks beside the port
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class MetricContext(NamedTuple):
    """What a per-layer metric's reader may read."""
    trace: trace.Trace
    steps: int  # batches or steps in the traced stretch
    items: int  # images in the traced stretch
    host: dict  # the window's host-clock totals: call_s, calls
    config: dict
    traffic: dict
    flops_per_item: int | None  # the traffic kind's count, if it has one


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(cell: cells.Cell, *, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, system=None,
        marks: list | None = None) -> dict:
    """Run ``cell`` once; returns the result line's object (without the
    forbidden-module check, which the caller makes last). ``system``
    replaces the program (the control, or a fault in a test); ``marks``,
    (name, host time) pairs of the set-up so far, gain the driver's."""
    kind = cells.kind_of(cell)
    kwargs = {} if system is None else {"system": system}
    driver = kind.Driver(cell, seed, device, **kwargs)
    driver.marks = marks = list(marks or [])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    win = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if not traced:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(win["end_to_end"], setup_s=setup_s)
        for name, unit in units.items():
            if name not in values:
                raise KeyError(f"{cell.name} reports no {name}")
            metrics[name] = {"value": values[name], "unit": unit}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if traced:
        run_fn, counts = driver.traced_run()
        tr = trace.record(run_fn, f"{cell.name}.seed{seed}", cuda=cuda)
        flops = getattr(kind, "flops_per_item", None)
        ctx = MetricContext(tr, counts["steps"], counts["items"],
                            win["host"], cell.config,
                            cell.workload["traffic"],
                            flops(cell.config) if flops else None)
        for m in cell.per_layer:
            value = cells.reader(m["name"], cell.root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = tr.breakdown()
    if cuda:
        dev_info["power_limit"] = power_limit()
    gc.collect()
    t_check = time.perf_counter()
    checks = driver.check()
    check_s = time.perf_counter() - t_check
    correct = all(v <= limit for v, limit in checks.values())
    out = {"correct": bool(correct and win["failed"] == 0),
           "attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    at, phases = t_start, {}
    for name, t in marks:
        phases[name], at = t - at, t
    out["timings"] = {"setup_phases_s": phases, "check_s": check_s}
    if getattr(driver, "notes", None):
        out["notes"] = driver.notes  # readings beside the checks
    out["checks"] = {name: {"value": v, "limit": limit}
                     for name, (v, limit) in checks.items()}
    return out
