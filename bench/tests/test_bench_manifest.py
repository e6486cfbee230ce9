"""BENCHMARK.json against the benchmark's contract and its own files: names,
units and keys; every configuration used; every metric's reader, every
cell's files; `moves` pointing at an end-to-end metric of the same cells;
and a cell added as files alone, found and run."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from bench.harness import cells

ROOT = cells.ROOT
MAN = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
CELLS = [w["name"] for w in MAN["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(MAN) == TOP_KEYS
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in
                                            MAN["command"])
    assert (ROOT / MAN["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == CONFIG_KEYS
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"])
    assert entry["file"].startswith("bench/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("entry", MAN["workloads"], ids=lambda e: e["name"])
def test_cell_entries(entry):
    assert set(entry) == CELL_KEYS
    for key in ("name", "config", "traffic"):
        assert NAME.match(entry[key])
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    wl = cells.load_json("workloads", entry["name"])
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"]
    assert (ROOT / "bench" / "traffic"
            / f"{wl['traffic']['kind']}.py").is_file()
    assert wl["limits"], "a cell compares at least one number"
    cell = cells.load(entry["name"])
    kind = cells.kind_of(cell)
    for name in ("Driver", "CONTROL", "FAULTS", "CPU_TEST"):
        assert hasattr(kind, name), name
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_names_unique_and_four_chip_share():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(m):
    assert set(m) - {"workloads"} == E2E_KEYS
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics(m):
    assert set(m) - {"workloads"} == LAYER_KEYS
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and _line(m["layer"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert cells.reader_path(m["name"]).is_file()
    e2e = {e["name"]: e for e in MAN["end_to_end"]}
    assert m["moves"] in e2e
    # every cell that reads the metric reports what it moves
    moved_in = set(e2e[m["moves"]].get("workloads", CELLS))
    assert set(m.get("workloads", moved_in)) <= moved_in
    if "mfu" in m["name"] or m["name"].endswith("_roofline") \
            or "roofline" in m["name"]:
        assert m["unit"] == "%"


def test_layer_names_consistent():
    by_layer: dict[str, set] = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path):
    """A new workload file and its manifest entry, no other edit: the
    harness finds the cell by name and runs it (on the CPU, small)."""
    import torch

    from bench.harness import runner

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("traces", ".cache",
                                                  "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = "fig5-hybrid.frames-b64"
    man["workloads"].append({"name": new, "config": "fig5-hybrid",
                             "traffic": "frames-b64", "chips": 1,
                             "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "fig5-hybrid.frames-b4096" in m.get("workloads", []):
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    wl = cells.load_json("workloads", "fig5-hybrid.frames-b4096")
    wl["traffic"].update(batch=64, pool_batches=2, trace_batches=2)
    (tmp_path / "bench" / "workloads" / f"{new}.json").write_text(
        json.dumps(wl))
    cell = cells.load(new, tmp_path)
    assert cell.workload["traffic"]["batch"] == 64
    cell = cell._replace(config=dict(cell.config,
                                     calibration_frames_per_class=8))
    out = runner.run(cell, seed=7, seconds=0.2, traced=False,
                     device=torch.device("cpu"), t_start=0.0)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"classify_per_s", "classify_p95_ms",
                                   "setup_s"}


NEW_KIND = '''"""Traffic kind ``frames-pageable``: ``frames``, its pool in
pageable host memory."""
from pathlib import Path

from bench.harness import cells

_FRAMES = cells.load_module("traffic", "frames",
                            Path(__file__).resolve().parents[2])
CONTROL, FAULTS, CPU_TEST = _FRAMES.CONTROL, _FRAMES.FAULTS, _FRAMES.CPU_TEST
flops_per_item = _FRAMES.flops_per_item


class Driver(_FRAMES.Driver):
    def setup(self):
        super().setup()
        self.pool = self.pool.clone()  # the copy is not pinned
'''

NEW_READER = '''"""traced_batches: the batches of the traced stretch."""


def read(ctx):
    return float(ctx.steps)
'''


def test_a_kind_config_and_metric_added_as_files_alone_are_found_and_run(
        tmp_path):
    """A new traffic kind, configuration, cell and per-layer metric, each
    a new file with its manifest entry and no other edit: the harness
    finds them by name, runs the cell (on the CPU, small) and reads the
    metric, and the kind's own control and faults read not correct."""
    import torch

    from bench.harness import runner
    from bench.tests.test_bench_checks import small

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("traces", ".cache",
                                                  "__pycache__"))
    bench = tmp_path / "bench"
    (bench / "traffic" / "frames-pageable.py").write_text(NEW_KIND)
    (bench / "metrics" / "traced_batches.py").write_text(NEW_READER)
    cfg = cells.load_json("configs", "fig5-hybrid")
    cfg.update(name="fig5-hybrid-k1", templates_per_class=1)
    (bench / "configs" / "fig5-hybrid-k1.json").write_text(json.dumps(cfg))
    new = "fig5-hybrid-k1.frames-pageable"
    wl = cells.load_json("workloads", "fig5-hybrid.frames-b4096")
    wl["config"], wl["traffic"]["kind"] = "fig5-hybrid-k1", "frames-pageable"
    (bench / "workloads" / f"{new}.json").write_text(json.dumps(wl))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "fig5-hybrid-k1", "source": "a test",
                           "file": "bench/configs/fig5-hybrid-k1.json",
                           "reduced": [], "why": "a test configuration"})
    man["workloads"].append({"name": new, "config": "fig5-hybrid-k1",
                             "traffic": "frames-pageable", "chips": 1,
                             "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "fig5-hybrid.frames-b4096" in m.get("workloads", []):
            m["workloads"].append(new)
    man["per_layer"].append({
        "name": "traced_batches.pageable", "unit": "batches",
        "better": "higher", "source": "program_counter", "layer": "test",
        "moves": "classify_per_s", "workloads": [new]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    cell = small(cells.load(new, tmp_path))
    assert cell.config["templates_per_class"] == 1
    kind = cells.kind_of(cell)
    cpu = torch.device("cpu")

    def run(system=None, traced=False):
        return runner.run(cell, seed=9, seconds=0.05, traced=traced,
                          device=cpu, t_start=0.0, system=system)

    out = run(traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["traced_batches.pageable"]["value"] == \
        cell.workload["traffic"]["trace_batches"]
    for system in [kind.CONTROL, *kind.FAULTS.values()]:
        out = run(system)
        assert not out["correct"], out["checks"]
