"""Paper Table II: classification accuracy against templates per class
(1, 2, 3; k-means for k > 1), binary feature-count matching, then the
silhouette-score selection of k on the first 1,500 training features."""
from __future__ import annotations

import time

import torch

from repro_torch.benchmarks import common
from repro_torch.core import hybrid, templates
from repro_torch.device import resolve


def _synced(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def run(device=None) -> list[dict]:
    """One row per k (accuracy, and ``fit_s``: the seconds of
    `fit_acam_head`, features and k-means included), then the silhouette
    row (``select_s``: the seconds of `select_k_by_silhouette`), on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve(device)
    d = common.data()
    m = common.models(dev)
    gtr, ytr = d["gray_tr"]
    gte, yte = d["gray_te"]
    params = m["student_opt"]

    rows = []
    for k in (1, 2, 3):
        t0 = _synced(dev)
        head = hybrid.fit_acam_head(common.student_feature_fn, params,
                                    gtr, ytr, 10, k=k, device=dev)
        fit_s = _synced(dev) - t0
        clf = hybrid.HybridClassifier(params, common.student_feature_fn,
                                      head, device=dev)
        rows.append({"templates_per_class": k,
                     "accuracy": clf.accuracy(gte, yte), "fit_s": fit_s})

    feats = torch.as_tensor(common.collect_features(params, gtr[:1500]),
                            device=dev)
    labels = torch.as_tensor(ytr[:1500], device=dev)
    t0 = _synced(dev)
    best_k, scores = templates.select_k_by_silhouette(feats, labels, 10)
    select_s = _synced(dev) - t0
    rows.append({"silhouette_best_k": best_k,
                 "silhouette_scores": {k: round(v, 4)
                                       for k, v in scores.items()},
                 "select_s": select_s})
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
