"""The program's own spans in a traced stretch: the ``repro_torch.*``
ranges that `repro_torch.obs.span` records while the profiler runs
(``user_annotation`` events of the trace, clipped to the window like every
host event). The readers of the ``program_span`` metrics read them here."""
from __future__ import annotations

from typing import Callable

from bench.harness.trace import Trace

PREFIX = "repro_torch."


def program_spans(tr: Trace) -> list:
    return [e for e in tr.host if e.cat == "user_annotation"
            and e.name.startswith(PREFIX)]


def host_ms(ctx, keep: Callable[[str], bool]) -> float | None:
    """Summed milliseconds of the program's spans whose names ``keep``
    selects, per batch or step of the stretch: 0.0 where the program
    recorded spans but none of these, None where it recorded none (a
    program without spans)."""
    spans = program_spans(ctx.trace)
    if not spans:
        return None
    us = sum(e.end - e.start for e in spans if keep(e.name))
    return us / ctx.steps / 1e3


def open_intervals(tr: Trace) -> list[tuple[float, float]]:
    """The union of the program's spans' intervals: `Trace.busy`'s merge,
    run over the spans (sorted by start, as the trace's host events are) in
    place of the device operations."""
    return Trace(tr.start, tr.end, program_spans(tr), []).busy()


def overlap(xs: list, ys: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
