"""ACAM template generation (paper §II-D-1), one template per class.

Run the front-end over a calibration set, threshold the penultimate feature
maps (mean- or median-based, `repro_torch.core.quant`), and distil each
class into a binary point template (feature-count matching, Eq. 8) and a
binary window [T^L, T^U] from the class mean +/- width * std (similarity
matching, Eq. 9-11). Several templates per class (k-means, silhouette) come
with the training path of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import quant


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


def generate_templates(features: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, *, k: int = 1,
                       threshold_method: str = "mean",
                       window_width: float = 1.0,
                       binary_windows: bool = True) -> TemplateBank:
    """Build the template bank from front-end feature maps.

    features: (n, num_features) float; labels: (n,) int class labels.
    Classes without samples keep ``valid = False``. Window bounds are the
    class mean +/- window_width * std, binarised like the point templates
    when ``binary_windows`` (the paper's deployed, fully binary setting).
    """
    if k != 1:
        raise NotImplementedError(
            "k > 1 templates per class (k-means + silhouette) come with the "
            "training slice of the port")
    thresholds = quant.feature_thresholds(features, threshold_method)
    nf = features.shape[1]
    dev = features.device
    tmpl = torch.zeros((num_classes, 1, nf), dtype=torch.float32, device=dev)
    lo = torch.zeros_like(tmpl)
    hi = torch.zeros_like(tmpl)
    valid = torch.zeros((num_classes, 1), dtype=torch.bool, device=dev)
    for c in range(num_classes):
        members = features[labels == c]
        if members.shape[0] == 0:
            continue
        mu = members.mean(dim=0)
        sd = members.std(dim=0, correction=0)
        tmpl[c, 0] = quant.binarize(mu, thresholds)
        l_, u_ = mu - window_width * sd, mu + window_width * sd
        if binary_windows:
            l_ = quant.binarize(l_, thresholds)
            u_ = torch.maximum(quant.binarize(u_, thresholds), l_)
        lo[c, 0] = l_
        hi[c, 0] = u_
        valid[c, 0] = True
    return TemplateBank(tmpl, lo, hi, valid, thresholds)
