"""Build the CUDA sources in `repro_torch/csrc/` with nvcc and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, bound with `ctypes`. The build happens at first use, into
``build/repro_torch/`` at the root of the checkout (``$REPRO_TORCH_BUILD_DIR``
overrides it), keyed on a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a fresh checkout builds its own kernels
and an edited source or header rebuilds.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3``. Never
``--use_fast_math``: it flushes subnormals to zero, and the serve kernel
binarises with ``(f - thr) > 0``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME): the CUDA "
                           "kernels of repro_torch are built from source")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{key[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns each started build's
    compiler output (``-Xptxas -v``: registers, shared memory, spills)."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs = {}
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def stream(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, the value of
    ``torch.cuda.current_stream(device).cuda_stream`` without building a
    Stream object (a few microseconds a call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(lib: ctypes.CDLL, name: str, device, launches: dict,
           *args) -> None:
    """Call C entry ``name`` of ``lib`` with ``args`` and ``device``'s
    current stream; raise on the CUDA error it returns, else add one to
    ``launches[name]``."""
    import torch

    fn = getattr(lib, name)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream(device))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    launches[name] += 1


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def bind(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """`load` with the argument types of each C entry set (``signatures``:
    entry -> ctypes types, the trailing stream included) and an int (a
    CUDA error code) returned. ctypes checks only the count of arguments
    against these, so they must match the source's declarations."""
    lib = load(name)
    for entry, argtypes in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
