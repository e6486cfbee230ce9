"""Benchmark harness of the port: one entry per paper table and figure,
then the kernel bench. Twin of the JAX package's `benchmarks/run.py`.

Prints ``name,us_per_call,derived`` CSV rows (the harness contract) and
writes every result dictionary to ``bench_details.json`` and the kernel
bench's ``BENCH_torch_kernels.json``, in ``--out DIR`` (default: the
working directory). ``REPRO_BENCH_FAST=1`` shrinks the training budget.
Runs on the card unless ``--device cpu`` (or ``device="cpu"``) asks for the
CPU.

    python -m repro_torch.benchmarks.run [--out DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None, *, device=None) -> list[tuple[str, float, str]]:
    """Run every benchmark; returns the CSV rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=".",
                    help="directory for bench_details.json and "
                         "BENCH_torch_kernels.json")
    ap.add_argument("--device", default=device,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.benchmarks import (common, energy_model,
                                        fig1_thresholds, fig6_7_confusion,
                                        kernel_bench, table1_compression,
                                        table2_templates)
    from repro_torch.device import resolve

    dev = resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    t_all = time.time()
    rows: list[tuple[str, float, str]] = []
    details: dict = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        us = (time.time() - t0) * 1e6
        details[name] = out
        return name, us, out

    # model training is shared; charge it to its own row (its details are
    # the scale and time, not the models)
    name, us, models = timed("train_models", lambda: common.models(dev))
    details[name] = dict(n_per_class=common.n_per_class(),
                         epochs=common.epochs(),
                         train_time_s=models["train_time_s"])
    rows.append((name, us, f"n_per_class={common.n_per_class()}"))

    name, us, out = timed("table1_compression",
                          lambda: table1_compression.run(dev))
    opt = next(r for r in out if r["model"] == "student_optimised")
    rows.append((name, us, f"opt_student_acc={opt['accuracy']:.4f}"))

    name, us, out = timed("table2_templates",
                          lambda: table2_templates.run(dev))
    accs = [r["accuracy"] for r in out if "accuracy" in r]
    rows.append((name, us, "k1/k2/k3=" + "/".join(f"{a:.4f}" for a in accs)))

    name, us, out = timed("fig1_thresholds", lambda: fig1_thresholds.run(dev))
    rows.append((name, us, f"mean={out['accuracy_mean']:.4f},"
                 f"median={out['accuracy_median']:.4f}"))

    name, us, out = timed("fig6_7_confusion",
                          lambda: fig6_7_confusion.run(dev))
    rows.append((name, us, f"acc={out['accuracy']:.4f}"))

    name, us, out = timed("energy_model", energy_model.run)
    rows.append((name, us, f"total={out['paper_total_nj']}nJ,"
                 f"reduction={out['paper_reduction_x']}x"))

    for r in kernel_bench.run(device=dev, out=os.path.join(
            args.out, "BENCH_torch_kernels.json")):
        rows.append((r["name"], r["us_per_call"], r["derived"]))

    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")

    path = os.path.join(args.out, "bench_details.json")
    with open(path, "w") as f:
        json.dump(details, f, indent=1, default=str)
    print(f"\ntotal {time.time()-t_all:.1f}s; details in {path}")
    return rows


if __name__ == "__main__":
    main()
