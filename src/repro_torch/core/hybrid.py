"""The hybrid edge classifier (paper Fig. 2): CNN front end + ACAM back end.

    inference: front-end features -> binarise -> ACAM match (Eq. 8)
               -> per-class max -> WTA (Eq. 12) -> class

`ACAMHead` replaces a model's dense softmax head with template matching;
all matching routes through `repro_torch.match.MatchEngine`, so the head
runs on the CUDA kernels (the default on the card) or the plain reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import match as match_lib
from repro_torch.core import energy as energy_lib
from repro_torch.core import templates
from repro_torch.device import resolve


class ACAMHead(NamedTuple):
    """Binary template-matching classification head. `bank` is what gets
    programmed once into the TXL-ACAM array; ``backend=None`` follows the
    process default (`repro_torch.match.default_backend`)."""

    bank: templates.TemplateBank
    method: str = "feature_count"
    alpha: float = 1.0
    backend: str | None = None

    def engine(self) -> match_lib.MatchEngine:
        return match_lib.engine_for(method=self.method, alpha=self.alpha,
                                    backend=self.backend)

    def __call__(self, features: torch.Tensor):
        """features (B, N) -> (pred, per_class): one `acam_match_classify`
        launch on the kernel backend."""
        return self.engine().classify_features(features, self.bank)

    def energy_per_inference(self) -> float:
        rows = int(self.bank.valid.sum())
        return energy_lib.backend_energy(rows, self.bank.num_features)


def fit_acam_head(feature_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  params: Any, inputs, labels, num_classes: int, *,
                  k: int = 1, threshold_method: str = "mean",
                  method: str = "feature_count", batch_size: int = 512,
                  device=None) -> ACAMHead:
    """Generate templates from a trained front end over a calibration set,
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve(device)
    feats = []
    with torch.no_grad():
        for i in range(0, len(inputs), batch_size):
            x = torch.as_tensor(inputs[i:i + batch_size],
                                dtype=torch.float32, device=dev)
            feats.append(feature_fn(params, x))
    bank = templates.generate_templates(
        torch.cat(feats), torch.as_tensor(labels, device=dev), num_classes,
        k=k, threshold_method=threshold_method)
    return ACAMHead(bank=bank, method=method)


class HybridClassifier(NamedTuple):
    """Front-end params + feature_fn + ACAM head, on ``device`` (the card
    unless the caller asks for the CPU)."""

    params: Any
    feature_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    head: ACAMHead
    device: str | None = None

    def predict(self, x) -> torch.Tensor:
        """Images -> (B,) int32 class ids: front end, then one fused
        classify kernel call."""
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=resolve(self.device))
        backend = self.head.backend or match_lib.default_backend()
        eng = match_lib.engine_for(method=self.head.method,
                                   alpha=self.head.alpha, backend=backend)
        with torch.no_grad():
            pred, _ = eng.classify_features(self.feature_fn(self.params, x),
                                            self.head.bank)
        return pred

    def accuracy(self, x, y, *, batch_size: int = 1024) -> float:
        correct = 0
        for i in range(0, len(x), batch_size):
            pred = self.predict(x[i:i + batch_size]).cpu()
            correct += int((pred == torch.as_tensor(
                y[i:i + batch_size])).sum())
        return correct / len(x)
