"""Paper Fig. 6/7: the confusion matrix and per-class accuracy of the
optimised student with the feature-count pattern-matching classifier."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import hybrid
from repro_torch.device import resolve


def run(device=None) -> dict:
    """On ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve(device)
    d = common.data()
    m = common.models(dev)
    gtr, ytr = d["gray_tr"]
    gte, yte = d["gray_te"]
    params = m["student_opt"]

    head = hybrid.fit_acam_head(common.student_feature_fn, params, gtr, ytr,
                                10, device=dev)
    preds = np.concatenate([
        head(common.student_feature_fn(params, gte[i:i + 512]))[0]
        .cpu().numpy() for i in range(0, len(yte), 512)])
    cm = np.zeros((10, 10), np.int64)
    for t, p in zip(yte, preds):
        cm[t, p] += 1
    per_class = (cm.diagonal() / np.maximum(cm.sum(axis=1), 1)).round(4)
    return {
        "confusion_matrix": cm.tolist(),
        "per_class_accuracy": per_class.tolist(),
        "accuracy": float((preds == yte).mean()),
    }


if __name__ == "__main__":
    out = run()
    print(np.asarray(out["confusion_matrix"]))
    print("per-class:", out["per_class_accuracy"])
    print("overall:", out["accuracy"])
