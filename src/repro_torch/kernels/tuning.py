"""The Hopper tuning table of the ACAM raw-score kernels (B7a, B7b).

The JAX package's table holds Pallas blocks ``(bm, bn, bk)`` sized against
VMEM. The port's kernels have no free block size; what a launch can choose
is a design, and that is the "block" here:

  acam_match       B7a's raw counts on the tiled kernel
                   (`csrc/acam_tiled.cuh`): ``"local"`` (each block
                   binarises the bank into shared memory itself; a plain
                   launch) or ``"cooperative"`` (a pack into bit scratch, a
                   grid sync, then the count).
  acam_similarity  B7b's register tiles (`csrc/acam_similarity.cu`):
                   ``"narrow"`` (2 queries x 12 window rows a block) or
                   ``"wide"`` (8 x 16).

Two layers, as in the JAX package:

  1. **Lookup** (`get_block`): the persistent cache's entry for
     ``kernel|platform|shape|dtype``, else the kernel's default. It never
     times anything; the wrappers call it at each launch.
  2. **Tuning** (`autotune`): an explicit search that times each candidate
     on the card with CUDA events (its device time: the calls queued
     behind a spin kernel) and writes the winner to the cache. A candidate
     counts only once its output is bit-identical to the plain version's;
     one that fails raises (a failed CUDA launch poisons the context, so
     there is nothing to skip to). Run it with ``python -m
     repro_torch.kernels.tuning`` or ``python -m
     repro_torch.benchmarks.kernel_bench --tune``.

Cache file: ``$REPRO_TORCH_TUNING_CACHE`` if set, else
``~/.cache/repro_torch/hopper_blocks.json``::

    {"version": 1,
     "entries": {"acam_match|cuda:sm_90|b256_m10_n784|float32":
                 {"block": "local", "us": 4.1}}}

Keys are exact shapes; the platform is ``cuda:sm_<major><minor>`` for a
card and ``cpu`` for the plain versions (which take no design). A cache of
another version is discarded on load; writes are atomic (tmp + rename).

Defaults (`default_block`) are the rules the kernels followed before the
table, so with an empty cache every launch takes the design it took
before: B7a local up to `acam_match.LOCAL_ROWS` template rows (read at each
call), cooperative past it; B7b wide where its grid gives two blocks an SM,
narrow otherwise.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import time
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.device import resolve
# the feature-count wrappers import this module too: only `LOCAL_ROWS` and
# `tiled_design` are read from it, at call time
from repro_torch.kernels.acam_match import acam_match as am

#: each tuned kernel's designs (B7b's C entry takes a design's index)
BLOCKS = {"acam_match": ("local", "cooperative"),
          "acam_similarity": ("narrow", "wide")}
#: B7b's block tiles (queries, window rows), as `csrc/acam_similarity.cu`
WIDE_TILE = (8, 16)
#: the H100's SMs: the B7b rule's count for a key with no card behind it
H100_SMS = 132
CACHE_VERSION = 1

Shape = tuple[int, int, int]


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNING_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "hopper_blocks.json")


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[str, int]:
    """(platform token, SM count) of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return f"cuda:sm_{props.major}{props.minor}", props.multi_processor_count


def _device(device) -> torch.device:
    dev = device if isinstance(device, torch.device) else resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def platform(device=None) -> str:
    """``cuda:sm_90`` on an H100, ``cpu`` for the plain versions; ``None``
    is the card (`repro_torch.device.resolve`)."""
    dev = _device(device)
    return _card(dev.index)[0] if dev.type == "cuda" else dev.type


def shape_key(b: int, m: int, n: int) -> str:
    return f"b{b}_m{m}_n{n}"


def entry_key(kernel: str, shape: Shape, dtype, device=None) -> str:
    b, m, n = shape
    return (f"{kernel}|{platform(device)}|{shape_key(b, m, n)}|"
            f"{str(dtype).removeprefix('torch.')}")


# ---------------------------------------------------------------------------
# Cache IO
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _load_cache() -> dict:
    try:
        with open(cache_path()) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        return {}
    return dict(data.get("entries", {}))


def _save_entry(key: str, block: str, us: float) -> None:
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    entries = dict(_load_cache())
    entries[key] = {"block": block, "us": us}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                  indent=1)
    os.replace(tmp, path)
    clear_cache_for_tests()


def clear_cache_for_tests() -> None:
    """Drop the in-process view of the cache (after pointing
    ``REPRO_TORCH_TUNING_CACHE`` elsewhere)."""
    _load_cache.cache_clear()
    _lookup.cache_clear()


# ---------------------------------------------------------------------------
# Candidates and defaults
# ---------------------------------------------------------------------------

def _designs(kernel: str) -> tuple[str, ...]:
    if kernel not in BLOCKS:
        raise ValueError(f"no tuning table for kernel {kernel!r}")
    return BLOCKS[kernel]


def check_block(kernel: str, block: str) -> str:
    """``block`` if it names a design of ``kernel``; raise otherwise."""
    if block not in _designs(kernel):
        raise ValueError(f"unknown {kernel} design {block!r}; use one of "
                         f"{BLOCKS[kernel]}")
    return block


def candidates(kernel: str, shape: Shape) -> list[str]:
    """The designs legal at ``shape`` = (B, M, N). Both designs of each
    kernel launch at every non-empty shape (neither needs more than the
    static shared memory of one block, and the cooperative grid is capped
    at the co-resident blocks); an empty shape launches nothing and has
    none."""
    return list(_designs(kernel)) if min(shape) >= 1 else []


def default_block(kernel: str, shape: Shape, device=None) -> str:
    """The design the kernel took before the table (module docstring)."""
    _designs(kernel)
    b, m, _ = shape
    if kernel == "acam_match":
        return am.tiled_design(m)
    dev = _device(device)
    sms = _card(dev.index)[1] if dev.type == "cuda" else H100_SMS
    blocks = -(-b // WIDE_TILE[0]) * -(-m // WIDE_TILE[1])
    return "wide" if blocks >= 2 * sms else "narrow"


def get_block(kernel: str, shape: Shape, dtype, device=None) -> str:
    """The cached design for (kernel, shape, dtype, platform), or the
    default. A pure lookup: it never times anything."""
    hit = _load_cache().get(entry_key(kernel, shape, dtype, device))
    if hit is not None:
        return check_block(kernel, hit["block"])
    return default_block(kernel, shape, device)


def resolve_block(kernel: str, shape: Shape, dtype, device: torch.device,
                  block: str | None) -> str:
    """The wrappers' helper: an explicit ``block`` wins (checked), else
    `get_block`, memoised per `acam_match.LOCAL_ROWS` (one cached lookup
    a launch)."""
    if block is not None:
        return check_block(kernel, block)
    return _lookup(kernel, shape, dtype, device, am.LOCAL_ROWS)


@functools.lru_cache(maxsize=1024)
def _lookup(kernel: str, shape: Shape, dtype, device: torch.device,
            local_rows: int) -> str:
    return get_block(kernel, shape, dtype, device)


# ---------------------------------------------------------------------------
# Tuning
# ---------------------------------------------------------------------------

def time_us(fn: Callable[[], object], device: torch.device,
            iters: int) -> float:
    """Median time of one call in microseconds: CUDA events on a card
    (after a warm-up call), the host clock on the CPU."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) * 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


#: spin cycles queued ahead of a timed run (about 10 ms at the H100's
#: 1.98 GHz): the host enqueues every timed call before the card reaches
#: them
HOLD_CYCLES = 20_000_000


def device_us(fn: Callable[[], object], device: torch.device,
              iters: int) -> float:
    """Mean device microseconds of one call: ``iters`` calls queued behind
    a spin kernel run back to back between two CUDA events, so the host's
    cost per call (the same for every design) is hidden. The host clock
    (`time_us`) on the CPU."""
    if device.type != "cuda":
        return time_us(fn, device, iters)
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e3 / iters


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.contiguous().view(torch.uint8),
                            want.contiguous().view(torch.uint8)))


def autotune(kernel: str, shape: Shape, dtype,
             run: Callable[[str], torch.Tensor], *, plain: torch.Tensor,
             cands: Sequence[str] | None = None, iters: int = 50,
             save: bool = True, times: dict | None = None) -> str:
    """Time ``run(block)`` for each candidate design; cache the fastest.

    ``run`` launches the kernel with the given design on bound operands;
    ``plain`` is the plain version's output on the same operands (and
    device). Each candidate must first give ``plain``'s bits exactly, else
    this raises. Each is timed on the card (`device_us`: at these shapes a
    call's host cost is several times its device time and the same for
    every design, so a per-call clock would pick by noise), in turns (the
    list, then the list reversed; each one's mean of the two). ``times``,
    if given, receives each candidate's microseconds.
    """
    cands = list(candidates(kernel, shape) if cands is None else cands)
    if not cands:
        raise ValueError(f"{kernel} has no candidate at shape {shape}")
    for block in cands:
        check_block(kernel, block)
        if not _same_bits(run(block), plain):
            raise RuntimeError(f"{kernel} design {block!r} at {shape} "
                               "differs from the plain version")
    us = {block: 0.0 for block in cands}
    for block in cands + cands[::-1]:
        us[block] += device_us(lambda: run(block), plain.device, iters) / 2
    best = min(cands, key=lambda blk: us[blk])
    if times is not None:
        times.update(us)
    if save:
        _save_entry(entry_key(kernel, shape, dtype, plain.device), best,
                    us[best])
    return best


def autotune_acam(shapes: Iterable[Shape] = ((1, 10, 784), (256, 10, 784)),
                  *, iters: int = 50, device=None, seed: int = 0,
                  times: dict | None = None) -> dict[str, str]:
    """Tune B7a and B7b at each (B, M, N) on ``device`` (the card unless
    the caller asks for the CPU); returns {cache key: design}. Queries are
    quarter steps and windows binary, so both kernels' outputs are exact
    and each candidate is held to the plain version bit for bit. ``times``,
    if given, receives {cache key: {design: us}}."""
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.kernels.acam_similarity import acam_similarity as asim

    dev = _device(device)
    gen = torch.Generator().manual_seed(seed)
    out: dict[str, str] = {}
    for b, m, n in shapes:
        f = (torch.randint(-8, 9, (b, n), generator=gen) / 4).to(dev)
        thr = torch.zeros(n, device=dev)
        t = (torch.rand((m, n), generator=gen) > 0.5).float().to(dev)
        lo = torch.zeros((m, n), device=dev)
        hi = (torch.rand((m, n), generator=gen) > 0.3).float().to(dev)
        runs = {
            "acam_match": (lambda blk: am.acam_match(f, thr, t, block=blk),
                           am.match_plain(f, thr, t)),
            "acam_similarity": (
                lambda blk: asim.acam_similarity(f, lo, hi, block=blk),
                asim.similarity_plain(f, lo, hi))}
        for kernel, (run, plain) in runs.items():
            key = entry_key(kernel, (b, m, n), torch.float32, dev)
            cand_us: dict = {}
            out[key] = autotune(kernel, (b, m, n), torch.float32, run,
                                plain=plain, iters=iters, times=cand_us)
            if times is not None:
                times[key] = cand_us
    return out


if __name__ == "__main__":
    for key, blk in autotune_acam().items():
        print(f"{key} -> {blk}")
