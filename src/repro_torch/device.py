"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card and raises when there is none: the port
    never falls back to the CPU on its own. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                'pass device="cpu" to run the plain PyTorch path')
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
