"""Run one cell of the benchmark of the PyTorch / CUDA port once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for (it exits 2 without them). Prints the checks' numbers and limits as the
last lines of standard error and one JSON object as the last line of
standard output: ``--trace 0`` the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics, the device's busy time over the traced stretch and
a breakdown. See bench/README.md.
"""
import time

T_START = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "bench" / ".cache"


def prepare_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's CUDA libraries in its default ``build/repro_torch``), and
    the checkout's ``src/`` and root importable. Before torch is
    imported."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(CACHE / "hopper_blocks.json")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    # not bench/ itself: its folders are no top-level modules
    here = str(ROOT / "bench")
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    prepare_environment()
    import torch

    from bench.harness import cells, runner

    marks = [("imports", time.perf_counter())]
    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = runner.run(cell, seed=args.seed, seconds=args.seconds,
                     traced=bool(args.trace), device=torch.device("cuda", 0),
                     t_start=T_START, marks=marks)
    found = runner.forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
