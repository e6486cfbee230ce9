"""Find a cell and everything it names, by name, from files.

``BENCHMARK.json`` at the checkout's root lists the cells and the metrics;
``bench/workloads/<cell>.json`` holds the cell's traffic parameters and the
limits of its checks; ``bench/configs/<config>.json`` its configuration;
``bench/traffic/<kind>.py`` its traffic kind: the ``Driver``, and what
the checks' tests and `bench/calibrate.py` run in the program's place
(``CONTROL``, ``FAULTS``) and at which CPU sizes (``CPU_TEST``); and
``bench/metrics/<metric>.py``, or ``bench/metrics/<stem>.py`` for a metric
``<stem>.<cell kind>``, the reader of each per-layer metric. Adding a cell,
configuration, traffic kind or metric adds files and entries and edits
none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Cell(NamedTuple):
    root: Path  # the checkout the cell's files are read from
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / "bench" / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``bench/<kind>/<name>.py`` (names may hold dots and dashes)."""
    path = root / "bench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r}: {path}")
    mod_name = "bench_{}_{}".format(kind, name.replace(".", "_")
                                    .replace("-", "_"))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_of(cell: "Cell") -> ModuleType:
    """The module of ``cell``'s traffic kind."""
    return load_module("traffic", cell.workload["traffic"]["kind"],
                       cell.root)


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``
    if there is one, else ``metrics/<stem>.py`` (``mfu`` for
    ``mfu.train``), so that one reader serves every cell kind."""
    folder = root / "bench" / "metrics"
    path = folder / f"{metric}.py"
    return path if path.is_file() else folder / f"{metric.split('.')[0]}.py"


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    return load_module("metrics", reader_path(metric, root).stem, root)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or, with no
    list, every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = load_json("workloads", name, root)
    config = load_json("configs", entry["config"], root)
    e2e = [m for m in man["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if reports(m, name, names)]
    return Cell(root, name, entry["chips"], config, workload, e2e,
                per_layer)
