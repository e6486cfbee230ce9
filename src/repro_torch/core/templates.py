"""ACAM template generation (paper §II-D-1).

Run the front-end over a calibration set, threshold the penultimate feature
maps (mean- or median-based, `repro_torch.core.quant`), and distil each
class into one or more binary point templates (feature-count matching,
Eq. 8) and binary windows [T^L, T^U] from each cluster's mean +/- width *
std (similarity matching, Eq. 9-11). Several templates per class come from
k-means on the class's feature maps; the silhouette score picks their
count.

k-means follows the JAX package step for step, because one flipped
assignment changes a template: the deterministic init (the point nearest
the data mean, then the point farthest from the centroids so far), exactly
``iters`` Lloyd steps with no early stop, an empty cluster keeping its
centroid, ties to the lowest index (`torch.argmin` / `argmax` return the
first), and squared distances as ``((x[:, None] - c[None]) ** 2).sum(-1)``.
`torch.cdist` and the ``|x|^2 - 2 x.c + |c|^2`` expansion round
differently and can flip an assignment. The centroid sums ``one_hot.T @ x``
run in full float32 on the card (`cnn.fp32`: no TF32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.models import cnn


class TemplateBank(NamedTuple):
    """Stored ACAM contents.

    templates:  (num_classes, k, num_features)  binary point templates
    lower:      (num_classes, k, num_features)  window lower bounds
    upper:      (num_classes, k, num_features)  window upper bounds
    valid:      (num_classes, k) bool — classes may use fewer than k templates
    thresholds: (num_features,) binarisation thresholds of the front-end
    """

    templates: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    valid: torch.Tensor
    thresholds: torch.Tensor

    @property
    def num_classes(self) -> int:
        return self.templates.shape[0]

    @property
    def k(self) -> int:
        return self.templates.shape[1]

    @property
    def num_features(self) -> int:
        return self.templates.shape[2]


# ---------------------------------------------------------------------------
# k-means (deterministic init) + silhouette score
# ---------------------------------------------------------------------------

def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances in the JAX package's formula."""
    return ((x[:, None, :] - c[None, :, :]) ** 2).sum(dim=-1)


def kmeans(x: torch.Tensor, k: int, *, iters: int = 25, key=None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means on ``x`` (n, d), on its device. Returns (centroids
    (k, d), assignment (n,) int64). ``key`` is unused, as in the JAX
    package: the init is deterministic, so templates are reproducible run
    to run (the paper's program-once flow)."""
    n, d = x.shape
    with torch.no_grad(), cnn.fp32(x.device):
        mean = x.mean(dim=0)
        first = torch.argmin(((x - mean) ** 2).sum(dim=1))
        cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
        cents[0] = x[first]
        cols = torch.arange(k, device=x.device)
        for i in range(1, k):
            unset = torch.where(cols < i, 0.0, float("inf"))
            d2 = (_sq_dist(x, cents) + unset[None, :]).amin(dim=1)
            cents[i] = x[torch.argmax(d2)]
        for _ in range(iters):
            assign = torch.argmin(_sq_dist(x, cents), dim=1)
            one_hot = F.one_hot(assign, k).to(x.dtype)
            counts = one_hot.sum(dim=0)[:, None]
            sums = one_hot.T @ x
            cents = torch.where(counts > 0,
                                sums / torch.clamp(counts, min=1), cents)
        assign = torch.argmin(_sq_dist(x, cents), dim=1)
    return cents, assign


def silhouette_score(x: torch.Tensor, assign: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Mean silhouette coefficient (the paper picks the template count by
    it), a 0-d tensor on ``x``'s device. O(n^2) pairwise distances: fine
    for one class's samples."""
    n = x.shape[0]
    with torch.no_grad(), cnn.fp32(x.device):
        d = torch.sqrt(torch.clamp(_sq_dist(x, x), min=0.0))
        own = (assign[:, None] == assign[None, :]) & ~torch.eye(
            n, dtype=torch.bool, device=x.device)
        # a(i): mean distance to its own cluster (itself excluded)
        own_cnt = own.sum(dim=1)
        a = torch.where(own, d, 0.0).sum(dim=1) / torch.clamp(own_cnt, min=1)
        # b(i): the least mean distance to another, non-empty cluster
        ids = torch.arange(k, device=x.device)
        in_c = assign[None, :] == ids[:, None]  # (k, n)
        cnt_c = in_c.sum(dim=1)
        mean_d_to_c = (d @ in_c.T.to(d.dtype)) / torch.clamp(cnt_c[None, :],
                                                             min=1)
        other = (ids[None, :] != assign[:, None]) & (cnt_c[None, :] > 0)
        b = torch.where(other, mean_d_to_c, float("inf")).amin(dim=1)
        s = torch.where(own_cnt > 0, (b - a) / torch.clamp(
            torch.maximum(a, b), min=1e-12), 0.0)
        return s.mean()


# ---------------------------------------------------------------------------
# Template generation
# ---------------------------------------------------------------------------

def generate_templates(features: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, *, k: int = 1,
                       threshold_method: str = "mean",
                       window_width: float = 1.0,
                       binary_windows: bool = True) -> TemplateBank:
    """Build the template bank from front-end feature maps, on their
    device.

    features: (n, num_features) float; labels: (n,) int class labels;
    k: templates per class (k-means centroids when k > 1). A class without
    samples keeps ``valid = False``; a class with fewer than k samples
    takes one template from its mean; a cluster left empty stays invalid.
    Window bounds are each cluster's mean +/- window_width * std
    (population std), binarised like the point templates when
    ``binary_windows`` (the paper's deployed, fully binary setting; then
    ``upper = max(upper, lower)``).
    """
    thresholds = quant.feature_thresholds(features, threshold_method)
    nf = features.shape[1]
    dev = features.device
    tmpl = torch.zeros((num_classes, k, nf), dtype=torch.float32, device=dev)
    lo = torch.zeros_like(tmpl)
    hi = torch.zeros_like(tmpl)
    valid = torch.zeros((num_classes, k), dtype=torch.bool, device=dev)
    for c in range(num_classes):
        xc = features[labels == c]
        if xc.shape[0] == 0:
            continue
        if k == 1 or xc.shape[0] < k:
            assign, used = None, 1
        else:
            _, assign = kmeans(xc, k)
            used = k
        for j in range(used):
            members = xc if assign is None else xc[assign == j]
            if members.shape[0] == 0:
                continue
            mu = members.mean(dim=0)
            sd = members.std(dim=0, correction=0)
            tmpl[c, j] = quant.binarize(mu, thresholds)
            l_, u_ = mu - window_width * sd, mu + window_width * sd
            if binary_windows:
                l_ = quant.binarize(l_, thresholds)
                u_ = torch.maximum(quant.binarize(u_, thresholds), l_)
            lo[c, j] = l_
            hi[c, j] = u_
            valid[c, j] = True
    return TemplateBank(tmpl, lo, hi, valid, thresholds)


def select_k_by_silhouette(features: torch.Tensor, labels: torch.Tensor,
                           num_classes: int, candidate_ks=(1, 2, 3)
                           ) -> tuple[int, dict[int, float]]:
    """Pick templates per class by the mean per-class silhouette (paper
    §II-D-1). k = 1 scores 0 by convention (no claim of cluster
    structure); a larger k wins only if its clusters are separated. A k
    with no class of more than k samples scores -1. The mean is taken in
    float32, as the JAX package takes it."""
    scores: dict[int, float] = {}
    for k in candidate_ks:
        if k == 1:
            scores[1] = 0.0
            continue
        per_class = []
        for c in range(num_classes):
            xc = features[labels == c]
            if xc.shape[0] <= k:
                continue
            _, assign = kmeans(xc, k)
            per_class.append(float(silhouette_score(xc, assign, k)))
        scores[k] = float(torch.tensor(per_class, dtype=torch.float32)
                          .mean()) if per_class else -1.0
    best = max(scores, key=lambda kk: scores[kk])
    return best, scores
