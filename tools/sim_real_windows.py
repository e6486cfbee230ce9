"""Time kernels of the port for one or more checkouts, each in a process
of its own and in the order given, so that two trees compare on one card
(for example parent, change, change, parent).

    python3 tools/sim_real_windows.py [--what NAME] [--report OUT.json]
        ROOT [ROOT ...]

Each ROOT is a checkout whose ``src/repro_torch`` is timed; its kernels
build into its own ``build/repro_torch/``. The timing is the function NAME
of the chip_smoke.py beside this folder: ``real_window_times`` (the
default: B5 at predict's (256, 10, 1, 784), B6 at the serving tick's (64,
128, 2, 784) and on the big bank (64, 1,100, 2, 784), on real windows) or
``redesign_times`` (B7b at (256, 10, 784) and (64, 2,200, 784), B8 at
(128, 10), (64, 32000) and (8, 152064)): each held to its plain version,
then call and device time per call and the bound. They use only the
wrappers' Python interface, so any checkout whose wrappers keep their
signatures can be timed. Needs a CUDA card; prints the card's name and
power limit, then one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


WHAT = ("real_window_times", "redesign_times")


def one(root: str, what: str) -> dict:
    """The times of the checkout at ``root`` (in this process)."""
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke

    return getattr(chip_smoke, what)(torch.device("cuda", 0))


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1], argv[2])))
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", help="checkouts, in turn order")
    parser.add_argument("--what", choices=WHAT, default=WHAT[0],
                        help="the chip_smoke timing to run")
    parser.add_argument("--report", type=Path, default=None,
                        help="also write the runs as JSON here")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sim_real_windows: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--one", root,
                               args.what], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{root}: exit {proc.returncode}\n{proc.stderr[-6000:]}",
                  file=sys.stderr)
            return proc.returncode
        runs.append(dict(root=root,
                         times=json.loads(proc.stdout.splitlines()[-1])))
        print(json.dumps(runs[-1]))
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(dict(card=card, runs=runs),
                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
