"""The numbers a check compares, each against the reference."""
from __future__ import annotations

import statistics

import torch


def worst_row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's ``|got - want|`` (L2) over the larger of that row's
    ``|want|`` and the median row's, ``got`` taken to ``want``'s type."""
    diff = torch.linalg.vector_norm(got.to(want) - want, dim=1)
    norm = torch.linalg.vector_norm(want, dim=1)
    floor = norm.median()
    return float((diff / torch.maximum(norm, floor)).max())


def leaf_gaps(got: dict, want: dict, keys=None) -> list[float]:
    """Each leaf's gap between the norms, ``| |got| - |want| |``, over the
    larger of that leaf's ``|want|`` and the median leaf's."""
    keys = list(want) if keys is None else list(keys)
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in want}
    floor = statistics.median(norms.values())
    return [abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k])
            / max(norms[k], floor) for k in keys]



def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)
