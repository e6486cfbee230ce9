"""The program's modules, loaded with the weights the benchmark drew."""
from __future__ import annotations

from typing import Callable

import torch


def module(make: Callable[[], torch.nn.Module], weights: dict,
           device: torch.device) -> torch.nn.Module:
    """``make()`` built without drawing its own initial weights, then
    given ``weights`` (parameters and BatchNorm statistics) on ``device``."""
    with torch.device("meta"):
        m = make()
    m = m.to_empty(device=device)
    state = dict(weights)
    for name, buf in m.named_buffers():
        if name not in state:  # BatchNorm's step counter, unread
            state[name] = torch.zeros_like(buf)
    m.load_state_dict(state)
    return m.eval()


def student_config(cfg: dict):
    from repro_torch.models import cnn

    return cnn.StudentConfig(in_channels=cfg["in_channels"],
                             filters=tuple(cfg["filters"]),
                             num_classes=cfg["num_classes"])


def teacher_config(cfg: dict):
    from repro_torch.models import cnn

    return cnn.TeacherConfig(in_channels=cfg["in_channels"],
                             width=cfg["teacher_width"],
                             blocks_per_stage=cfg["teacher_blocks_per_stage"],
                             num_classes=cfg["num_classes"])
