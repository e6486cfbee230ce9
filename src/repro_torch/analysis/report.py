"""Assemble the roofline table from the port's dry-run JSON records
(`repro_torch.launch.dryrun`): the JAX package's `repro/analysis/report.py`,
the same table from the port's records.

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir experiments/dryrun]

Emits the §Roofline markdown table plus hillclimb-candidate ranking (worst
roofline fraction / most collective-bound). Its times are the H100 roofline's
(`repro_torch.analysis.roofline`): analysis, not measurements.
"""
from __future__ import annotations

import argparse
import json
import pathlib


def load(dir_: str) -> list[dict]:
    recs = []
    for p in sorted(pathlib.Path(dir_).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def table(recs: list[dict], mesh: str = "pod16x16", opt: bool = False) -> str:
    rows = ["| arch | shape | mode | t_compute | t_memory | t_collective | "
            "dominant | useful | MFU-bound | args/dev | temp/dev |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("skipped") or r["mesh"] != mesh or bool(r.get("opt")) != opt:
            continue
        ro = r["roofline"]
        mem = r.get("memory", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r.get('mode','?')} | "
            f"{fmt_s(ro['t_compute_s'])} | {fmt_s(ro['t_memory_s'])} | "
            f"{fmt_s(ro['t_collective_s'])} | {ro['dominant']} | "
            f"{ro['useful_frac']:.2f} | {ro['mfu_bound']*100:.1f}% | "
            f"{mem.get('argument_bytes', 0)/2**30:.1f}GiB | "
            f"{mem.get('temp_bytes', 0)/2**30:.1f}GiB |")
    return "\n".join(rows)


def compare(recs: list[dict], mesh: str = "pod16x16") -> str:
    """Baseline vs --opt side-by-side (t_bound and MFU-bound)."""
    base = {(r["arch"], r["shape"]): r for r in recs
            if not r.get("skipped") and r["mesh"] == mesh and not r.get("opt")}
    opt = {(r["arch"], r["shape"]): r for r in recs
           if not r.get("skipped") and r["mesh"] == mesh and r.get("opt")}
    rows = ["| arch | shape | t_bound base | t_bound opt | speedup | "
            "MFU base | MFU opt |", "|---|---|---|---|---|---|---|"]
    for key in sorted(base):
        if key not in opt:
            continue
        b, o = base[key]["roofline"], opt[key]["roofline"]
        sp = b["t_bound_s"] / max(o["t_bound_s"], 1e-12)
        rows.append(f"| {key[0]} | {key[1]} | {fmt_s(b['t_bound_s'])} | "
                    f"{fmt_s(o['t_bound_s'])} | {sp:.2f}x | "
                    f"{b['mfu_bound']*100:.1f}% | {o['mfu_bound']*100:.1f}% |")
    return "\n".join(rows)


def candidates(recs: list[dict], mesh: str = "pod16x16") -> dict:
    live = [r for r in recs if not r.get("skipped") and r["mesh"] == mesh
            and not r.get("opt")]
    worst_frac = min(live, key=lambda r: r["roofline"]["roofline_frac"])
    most_coll = max(live, key=lambda r: (r["roofline"]["t_collective_s"]
                                         / max(r["roofline"]["t_bound_s"], 1e-12)
                                         * r["roofline"]["t_collective_s"]))
    return {"worst_roofline_frac": (worst_frac["arch"], worst_frac["shape"]),
            "most_collective_bound": (most_coll["arch"], most_coll["shape"])}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--opt", action="store_true")
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.compare:
        print(compare(recs, args.mesh))
        return
    print(table(recs, args.mesh, opt=args.opt))
    print()
    print("hillclimb candidates:", candidates(recs, args.mesh))


if __name__ == "__main__":
    main()
