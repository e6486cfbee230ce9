"""The paper's ACAM back end (§II-D, Eq. 8 and Eq. 12), written from the
paper and the configuration in plain PyTorch, for the benchmark's checks.

Templates (§II-D-1): each feature's threshold is its mean over the
calibration set; a feature binarises to 1 where it is above its threshold.
Each class's calibration features split into k clusters by Lloyd's k-means
(as the configuration states it: the first centroid the point nearest the
class mean, each next the point farthest from the centroids so far, then
exactly ``iters`` steps, a cluster left empty keeping its centroid, ties
to the lower index); a cluster's template is its mean, binarised. Matching
(Eq. 8) counts the features on which the binarised query equals a
template; each class scores its best valid template and the query takes
the highest-scoring class, the lowest index on a tie (Eq. 12).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Bank(NamedTuple):
    templates: torch.Tensor  # (C, K, N) bool
    valid: torch.Tensor  # (C, K) bool
    thresholds: torch.Tensor  # (N,)


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return ((x[:, None, :] - c[None, :, :]) ** 2).sum(dim=-1)


def kmeans(x: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """The cluster of each row of ``x`` (n, d)."""
    first = torch.argmin(((x - x.mean(dim=0)) ** 2).sum(dim=1))
    cents = x[first][None]
    for _ in range(1, k):
        far = torch.argmax(_sq_dist(x, cents).amin(dim=1))
        cents = torch.cat([cents, x[far][None]])
    for _ in range(iters):
        assign = torch.argmin(_sq_dist(x, cents), dim=1)
        sums = torch.zeros_like(cents).index_add_(0, assign, x)
        counts = torch.bincount(assign, minlength=k)[:, None]
        cents = torch.where(counts > 0, sums / counts.clamp(min=1), cents)
    return torch.argmin(_sq_dist(x, cents), dim=1)


def build_bank(features: torch.Tensor, labels: torch.Tensor,
               num_classes: int, k: int, iters: int) -> Bank:
    thr = features.mean(dim=0)
    n = features.shape[1]
    tmpl = torch.zeros((num_classes, k, n), dtype=torch.bool,
                       device=features.device)
    valid = torch.zeros((num_classes, k), dtype=torch.bool,
                        device=features.device)
    for c in range(num_classes):
        xc = features[labels == c]
        if xc.shape[0] == 0:
            continue
        if k == 1 or xc.shape[0] < k:
            assign = torch.zeros(xc.shape[0], dtype=torch.long,
                                 device=xc.device)
        else:
            assign = kmeans(xc, k, iters)
        for j in range(k):
            members = xc[assign == j]
            if members.shape[0]:
                tmpl[c, j] = members.mean(dim=0) > thr
                valid[c, j] = True
    return Bank(tmpl, valid, thr)


def classify(features: torch.Tensor, bank: Bank, rows: int = 1024
             ) -> torch.Tensor:
    """(B,) class of each row of ``features``, ``rows`` rows at a time."""
    c, k, n = bank.templates.shape
    t = bank.templates.reshape(c * k, n).to(torch.float64)
    out = []
    for i in range(0, features.shape[0], rows):
        q = (features[i:i + rows] > bank.thresholds).to(torch.float64)
        score = q @ t.T + (1 - q) @ (1 - t).T  # Eq. 8, exact integers
        score = score.reshape(-1, c, k).masked_fill(~bank.valid,
                                                    float("-inf"))
        out.append(torch.argmax(score.amax(dim=-1), dim=-1))
    return torch.cat(out)
