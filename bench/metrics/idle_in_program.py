"""idle_in_program: the share of the traced stretch, in %, in which no
kernel, copy or memset ran on the card while one of the program's spans
(``repro_torch.*``) was open: the part of ``idle_share`` that the
program's own host time accounts for; the rest falls in the harness
between the program's calls."""

from bench.harness import spans


def read(ctx):
    tr = ctx.trace
    if not spans.program_spans(tr) or not tr.device:
        return None
    return spans.overlap(tr.gaps(), spans.open_intervals(tr)) / (
        tr.end - tr.start) * 100
