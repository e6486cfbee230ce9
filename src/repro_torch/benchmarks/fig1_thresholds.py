"""Paper Fig. 1: mean against median per-feature binarisation thresholds,
and the classification accuracy of each (§II-D-1: sparse ReLU feature maps
make the mean threshold the more discriminative)."""
from __future__ import annotations

import torch

from repro_torch.benchmarks import common
from repro_torch.core import hybrid, quant
from repro_torch.device import resolve


def run(device=None) -> dict:
    """Threshold statistics and both accuracies, on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve(device)
    d = common.data()
    m = common.models(dev)
    gtr, ytr = d["gray_tr"]
    gte, yte = d["gray_te"]
    params = m["student_opt"]

    feats = torch.as_tensor(common.collect_features(params, gtr), device=dev)
    mean_thr = quant.feature_thresholds(feats, "mean")
    med_thr = quant.feature_thresholds(feats, "median")

    out = {
        "mean_thr_avg": float(mean_thr.mean()),
        "median_thr_avg": float(med_thr.mean()),
        "frac_features_mean_below_median":
            float((mean_thr < med_thr).to(torch.float32).mean()),
        "feature_sparsity": float((feats == 0.0).to(torch.float32).mean()),
    }
    for method in ("mean", "median"):
        head = hybrid.fit_acam_head(common.student_feature_fn, params,
                                    gtr, ytr, 10, threshold_method=method,
                                    device=dev)
        clf = hybrid.HybridClassifier(params, common.student_feature_fn,
                                      head, device=dev)
        out[f"accuracy_{method}"] = clf.accuracy(gte, yte)
    return out


if __name__ == "__main__":
    print(run())
