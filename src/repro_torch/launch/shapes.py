"""Assigned input-shape sets and their meta-tensor stand-ins for the dry
run: the JAX package's `repro/launch/shapes.py`.

Shapes (from the assignment brief):
    train_4k     seq_len=4,096   global_batch=256   (training)
    prefill_32k  seq_len=32,768  global_batch=32    (inference-prefill)
    decode_32k   seq_len=32,768  global_batch=128   (inference-decode:
                 one new token with a KV cache of seq_len)
    long_500k    seq_len=524,288 global_batch=1     (long-context-decode)

Applicability: decode_* / long_* skip encoder-only archs; long_500k runs
only for SSM/hybrid archs (sub-quadratic state).

Where JAX has ``ShapeDtypeStruct``s the port has tensors on the meta
device of the same shape and dtype: nothing is allocated, at any width.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import lm

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

SHAPE_IDS = list(SHAPES)


def applicable(cfg: lm.ArchConfig, shape_id: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the brief's applicability rules."""
    kind = SHAPES[shape_id]["kind"]
    if not cfg.causal and kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape_id == "long_500k" and not (cfg.ssm or cfg.hybrid):
        return False, "pure full-attention arch skips long_500k (sub-quadratic required)"
    return True, ""


class CellSpecs(NamedTuple):
    """Meta-tensor stand-ins for one (arch x shape) dry-run cell."""
    kind: str  # train | prefill | decode
    args: tuple  # positional args for the step fn (after params/opt_state)
    seq: int
    batch: int


def _maybe_smoke(cfg: lm.ArchConfig, seq: int, batch: int, smoke: bool):
    if smoke:  # reduced geometry for CPU integration tests
        return min(seq, 64), min(batch, 4)
    return seq, batch


def _meta(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: lm.ArchConfig, shape_id: str, *, smoke: bool = False
                ) -> CellSpecs:
    """Build the (allocation-free) input meta tensors for a cell."""
    sh = SHAPES[shape_id]
    seq, batch = _maybe_smoke(cfg, sh["seq"], sh["batch"], smoke)
    kind = sh["kind"]
    f_embed = _meta((batch, seq, cfg.d_model), torch.bfloat16)
    i32 = torch.int32

    if kind == "train":
        batch_d: dict[str, Any] = {
            "inputs": (f_embed if cfg.input_mode == "embeds"
                       else _meta((batch, seq), i32)),
            "labels": _meta((batch, seq), i32),
        }
        if cfg.rope == "mrope":
            batch_d["positions"] = _meta((3, batch, seq), i32)
        return CellSpecs("train", (batch_d,), seq, batch)

    if kind == "prefill":
        inputs = (f_embed if cfg.input_mode == "embeds"
                  else _meta((batch, seq), i32))
        args: tuple = (inputs,)
        if cfg.rope == "mrope":
            args += (_meta((3, batch, seq), i32),)
        return CellSpecs("prefill", args, seq, batch)

    # decode: one new token against a cache of `seq` tokens
    cache = lm.init_cache(cfg, batch, seq, device="meta")
    tok = (_meta((batch, 1, cfg.d_model), torch.bfloat16)
           if cfg.input_mode == "embeds" else _meta((batch, 1), i32))
    return CellSpecs("decode", (tok, cache), seq, batch)
