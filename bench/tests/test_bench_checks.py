"""The checks that decide ``correct``, on the CPU at small sizes: the
program against the reference (correct), and the control and every fault
of the cell's traffic kind with the rest of a run as it is (not correct).
Every cell of ``BENCHMARK.json`` is run, at the sizes its traffic kind's
``CPU_TEST`` gives."""
from __future__ import annotations

import pytest
import torch

from bench.harness import cells, runner

CPU = torch.device("cpu")
CELLS = [w["name"] for w in cells.manifest()["workloads"]]


def resized(cell: cells.Cell, config=None, **traffic) -> cells.Cell:
    """``cell`` with some traffic parameters (and configuration keys)
    replaced."""
    workload = dict(cell.workload, traffic={**cell.workload["traffic"],
                                            **traffic})
    return cell._replace(workload=workload,
                         config={**cell.config, **(config or {})})


def small(cell: cells.Cell) -> cells.Cell:
    """``cell`` at the size its traffic kind runs on the CPU in a
    second."""
    sizes = cells.kind_of(cell).CPU_TEST
    return resized(cell, sizes["config"], **sizes["traffic"])


def run(name: str, seed: int, system=None, traced: bool = False,
        root=cells.ROOT) -> dict:
    torch.manual_seed(0)
    return runner.run(small(cells.load(name, root)), seed=seed,
                      seconds=0.05, traced=traced, device=CPU, t_start=0.0,
                      system=system)


def faults_of(name: str, root=cells.ROOT) -> dict:
    return cells.kind_of(cells.load(name, root)).FAULTS


def control_of(name: str, root=cells.ROOT):
    return cells.kind_of(cells.load(name, root)).CONTROL


@pytest.mark.parametrize("seed", [11, 2**31 + 12])
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name, seed):
    out = run(name, seed)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"  # the numbers compared come last
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_is_correct_and_reads_host_metrics(name):
    out = run(name, 21, traced=True)
    assert out["correct"]
    cell = cells.load(name)
    host = [m["name"] for m in cell.per_layer
            if m["source"] == "host_clock"]
    assert host and all(out["metrics"][m]["value"] > 0 for m in host)
    # no device on the CPU: no device metric is reported
    assert not any(m["name"] in out["metrics"] for m in cell.per_layer
                   if m["source"] == "device_trace")
    assert "breakdown" in out and out["device"]["window_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = run(name, 31, system=control_of(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in faults_of(name)])
def test_fault_is_not_correct(name, fault):
    out = run(name, 41, system=faults_of(name)[fault])
    assert not out["correct"], out["checks"]


def test_late_fault_is_caught_only_after_the_window():
    """A step that goes wrong only after set-up's checked steps passes
    every set-up check and fails the step after the window."""
    name = "fig5-distill.student-kd-b2048"
    out = run(name, 51, system=faults_of(name)["late_half_batch"])
    checks = out["checks"]
    after = {k for k in checks if "_after_window" in k}
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k not in after), checks
    assert any(checks[k]["value"] > checks[k]["limit"] for k in after)
