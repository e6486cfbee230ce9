"""The hybrid edge classifier (paper Fig. 2): CNN front end + ACAM back end.

    inference: front-end features -> binarise -> ACAM match (Eq. 8
               feature count, or Eq. 9-11 similarity) -> per-class max
               -> WTA (Eq. 12) -> class

`ACAMHead` replaces a model's dense softmax head with template matching;
all matching routes through `repro_torch.match.MatchEngine`, so the head
runs on the CUDA kernels (the default on the card), the plain reference, or
the RRAM device-physics models (``backend="device"``); `ACAMHead.to_acam`
programs its bank into a `repro_torch.core.acam` array.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import match as match_lib
from repro_torch import obs
from repro_torch.core import acam as acam_lib
from repro_torch.core import energy as energy_lib
from repro_torch.core import quant, templates
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
        """features (B, N) -> (pred, per_class): one fused classify launch
        (`acam_match_classify` / `acam_similarity_classify`) on the kernel
        backend."""
        return self.engine().classify_features(features, self.bank)

    def scores(self, features: torch.Tensor) -> torch.Tensor:
        """(B, C) per-class scores of the binarised features: the raw-score
        kernel (`acam_match` / `acam_similarity`), then the max over K."""
        q = quant.binarize(features, self.bank.thresholds)
        return self.engine().scores(q, self.bank).amax(dim=-1)

    def to_acam(self, config: acam_lib.ACAMConfig | None = None, key=None,
                *, device=None) -> acam_lib.ProgrammedACAM:
        """Flatten the bank class-major into a programmed ACAM array on
        ``device`` (the card unless the caller asks for the CPU)."""
        cfg = config or acam_lib.ACAMConfig()
        c, k, n = self.bank.templates.shape
        return acam_lib.program(self.bank.lower.reshape(c * k, n),
                                self.bank.upper.reshape(c * k, n),
                                self.bank.valid.reshape(c * k), cfg, key,
                                device=device)

    def energy_per_inference(self) -> float:
        rows = int(self.bank.valid.sum())
        return energy_lib.backend_energy(rows, self.bank.num_features)


def as_input(x, device: torch.device) -> torch.Tensor:
    """A front end's input on ``device``: integer inputs (token ids) keep
    their type, anything else becomes float32."""
    x = torch.as_tensor(x)
    if x.is_floating_point() or x.dtype == torch.bool:
        return x.to(device=device, dtype=torch.float32)
    return x.to(device)


def fit_acam_head(feature_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  params: Any, inputs, labels, num_classes: int, *,
                  k: int = 1, threshold_method: str = "mean",
                  method: str = "feature_count", batch_size: int = 512,
                  device=None) -> ACAMHead:
    """Generate templates from a trained front end over a calibration set,
    on ``device`` (the card unless the caller asks for the CPU); inputs
    as `as_input` hands them over."""
    dev = resolve(device)
    feats = []
    with torch.no_grad():
        for i in range(0, len(inputs), batch_size):
            x = as_input(inputs[i:i + batch_size], dev)
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
        """Images (or token ids, which keep their integer type) -> (B,)
        int32 class ids: front end, then one fused classify kernel call."""
        with obs.span("repro_torch.predict"):
            with obs.span("repro_torch.predict.to_device"):
                x = as_input(x, resolve(self.device))
            backend = self.head.backend or match_lib.default_backend()
            eng = match_lib.engine_for(method=self.head.method,
                                       alpha=self.head.alpha,
                                       backend=backend)
            with torch.no_grad():
                with obs.span("repro_torch.predict.frontend"):
                    features = self.feature_fn(self.params, x)
                pred, _ = eng.classify_features(features, self.head.bank)
        return pred

    def accuracy(self, x, y, *, batch_size: int = 1024) -> float:
        correct = 0
        for i in range(0, len(x), batch_size):
            pred = self.predict(x[i:i + batch_size]).cpu()
            correct += int((pred == torch.as_tensor(
                y[i:i + batch_size])).sum())
        return correct / len(x)
