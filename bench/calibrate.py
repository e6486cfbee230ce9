"""Read a cell's checks on the card: the program over many seeds (the lower
readings), the control (the reference in the program's place, one
precision below the configuration's) and the faults of the cell's traffic
kind (the upper readings; its module's ``CONTROL`` and ``FAULTS``), in one
process. The benchmark's own runs do not run this.

    python3 bench/calibrate.py --workload <cell> --first-seed <n> \\
        [--seeds 12] [--controls 3] [--faults 3] [--seconds 1]

Prints one JSON line a run (who, seed, correct, each check's number) and a
summary: the largest of the program's readings and the smallest of the
control's and of each fault's, per number.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench.run import ROOT, prepare_environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    prepare_environment()
    import torch

    from bench.harness import cells, runner

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    kind = cells.kind_of(cell)
    runs = [("program", None, args.seeds),
            ("control", kind.CONTROL, args.controls)]
    runs += [(name, system, args.faults)
             for name, system in kind.FAULTS.items()]
    seed = args.first_seed
    readings: dict = {}
    for who, system, count in runs:
        for _ in range(count):
            out = runner.run(cell, seed=seed, seconds=args.seconds,
                             traced=False, device=torch.device("cuda", 0),
                             t_start=time.perf_counter(), system=system)
            checks = {k: v["value"] for k, v in out["checks"].items()}
            checks.update(out.get("notes", {}))
            for k, v in checks.items():
                readings.setdefault(who, {}).setdefault(k, []).append(v)
            print(json.dumps({"who": who, "seed": seed,
                              "correct": out["correct"], "checks": checks,
                              "timings": out["timings"]}), flush=True)
            seed += 1
            torch.cuda.empty_cache()
    summary = {who: {k: (max(v) if who == "program" else min(v))
                     for k, v in nums.items()
                     if all(isinstance(x, float) for x in v)}
               for who, nums in readings.items()}
    print(json.dumps({"summary": summary, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
