"""The benchmark's CPU tests: the port (``src/``) importable, as in a run."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
