"""Trace a stretch of a run with `torch.profiler` and reduce it.

The stretch runs inside one host span (`WINDOW`) that ends after a device
synchronise, so every device operation it caused ends inside it. The trace
is exported as Chrome JSON under ``bench/traces/`` and read back: device
operations are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events,
each tied through its correlation id to the runtime call that launched it
and so to the ATen operators around that call (``launch``); host activity
the ``user_annotation`` spans the harness records, the ``cpu_op`` ATen
operators and the ``cuda_runtime`` / ``cuda_driver`` calls. A session that
records no device operation is taken again (up to two times): an empty
session has been seen on the card.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, NamedTuple

from bench.harness.cells import BENCH

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TRACES = BENCH / "traces"


class Event(NamedTuple):
    name: str
    cat: str
    start: float  # us
    end: float
    launch: str = ""  # the ATen operators around its launch, outer first


class Trace(NamedTuple):
    start: float  # us, the window's
    end: float
    device: list  # Events, by start
    host: list

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def device_s(self, keep: Callable[[Event], bool] = lambda e: True
                 ) -> float:
        """Summed time of the device operations ``keep`` selects."""
        return sum(e.end - e.start for e in self.device if keep(e)) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals."""
        out = []
        for e in self.device:
            if out and e.start <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e.end))
            else:
                out.append((e.start, e.end))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        out, at = [], self.start
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end > at:
            out.append((at, self.end))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost harness span,
        ATen operator and runtime call that cover it."""
        parts = []
        for cat in HOST_CATS:
            inner = min((e for e in self.host if e.cat == cat
                         and e.start <= t <= e.end and e.name != WINDOW),
                        key=lambda e: e.end - e.start, default=None)
            if inner is not None:
                parts.append(inner.name)
        return " > ".join(parts) or "host outside any span"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[name[:160], us / 1e6] for name, us in ops],
                "idle_gaps": [[self.host_at((a + b) / 2)[:160],
                               (b - a) / 1e6] for a, b in gaps]}


def parse(path: Path) -> Trace:
    events = json.loads(path.read_text()).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in spans if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError(f"{path}: no {WINDOW} span in the trace")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    launches = launch_stacks(spans)

    def clipped(cats):
        out = []
        for e in spans:
            if e.get("cat") not in cats:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b > w0 and a < w1:
                corr = e.get("args", {}).get("correlation")
                out.append(Event(e["name"], e["cat"], max(a, w0), min(b, w1),
                                 launches.get(corr, "")))
        return sorted(out, key=lambda e: e.start)

    return Trace(w0, w1, clipped(DEVICE_CATS), clipped(HOST_CATS))


def launch_stacks(spans: list) -> dict:
    """correlation id -> the ``cpu_op`` names open around the runtime call
    with that id on its thread, outer first, joined by " > "."""
    by_tid: dict = {}
    for e in spans:
        if e.get("cat") in ("cpu_op",) + LAUNCH_CATS:
            by_tid.setdefault(e.get("tid"), []).append(e)
    out = {}
    for events in by_tid.values():
        # outer operators first where two start together
        events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: list = []
        for e in events:
            a = float(e["ts"])
            while stack and float(stack[-1]["ts"]) + float(
                    stack[-1]["dur"]) < a:
                stack.pop()
            if e["cat"] == "cpu_op":
                stack.append(e)
            else:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    out[corr] = " > ".join(op["name"] for op in stack)
    return out


def record(run: Callable[[], None], label: str, *, cuda: bool,
           retries: int = 2) -> Trace:
    """Trace ``run()`` (host and device); the Chrome trace is kept at
    ``bench/traces/<label>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    TRACES.mkdir(parents=True, exist_ok=True)
    path = TRACES / f"{label}.json"
    for _ in range(retries + 1):
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                run()
                if cuda:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        tr = parse(path)
        if tr.device or not cuda:
            return tr
    raise RuntimeError(f"the profiler recorded no device operation in "
                       f"{retries + 1} sessions ({path})")
