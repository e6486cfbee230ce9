"""The LM's training step on one device, the JAX package's
`repro/launch/steps.py` and the body of its launcher's step.

`make_optimizer` is the JAX one: AdamW at weight decay 0.1, decaying what
the JAX tree decays (`decays`). `make_train_step` returns
``train_step(model, opt_state, err, batch)``, in the JAX launcher's order:
the loss and its gradient for every parameter, the optional int8
compression, clipping at global norm 1.0, then the AdamW update, written
into the model's parameters in place. On the card the forward and the
backward (with its recomputed layers) run in true f32 products and under
PyTorch's deterministic algorithms (the CNN trainer's `value_and_grad`:
set ``CUBLAS_WORKSPACE_CONFIG`` first), so a run is a function of its
seed.

`state_tree` / `load_state` are the checkpoint's ``{"params", "opt"}``
in the JAX launcher's layout. The sharded builders (``build_train_step``,
``build_prefill_step``, ``build_decode_step``) need a mesh and come with
the multi-GPU slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import convert
from repro_torch.models import lm
from repro_torch.optim import compression
from repro_torch.optim import optimizers as optim
from repro_torch.train import cnn_trainer


def decays(name: str, p: torch.Tensor) -> bool:
    """JAX's ``p.ndim >= 2`` read on its stacked tree: a per-layer leaf
    carries the layer axis there, so every one decays (the norm scales,
    biases, ``A_log``, ``D`` and ``dt_bias`` too); ``final_norm`` does
    not."""
    return p.ndim + name.startswith("layers.") >= 2


def make_optimizer(cfg: lm.ArchConfig, lr: float = 3e-4) -> optim.Optimizer:
    return optim.adamw(lr, weight_decay=0.1, decay=decays)


def value_and_grad(model: lm.LM, cfg: lm.ArchConfig, batch: dict
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """`lm.loss_fn` and its gradient for every parameter (each made to
    require grad): the CNN trainer's `value_and_grad`, in true f32
    products and deterministic on the card."""
    model.requires_grad_(True)
    return cnn_trainer.value_and_grad(
        lambda m, b: lm.loss_fn(m, cfg, b), model, (batch,))


def make_train_step(cfg: lm.ArchConfig, opt: optim.Optimizer, *,
                    compress: bool = False) -> Callable:
    """``train_step(model, opt_state, err, batch) -> (model, opt_state, err,
    loss)``. ``err`` is the compression's error carry over the JAX leaves
    (`init_error_state`), None without ``compress``."""

    def train_step(model, opt_state, err, batch):
        loss, grads = value_and_grad(model, cfg, batch)
        if compress:
            # one scale per JAX leaf: the layers' tensors stacked
            deq, err = compression.compress_decompress(
                convert.lm_stack(grads), err)
            grads = convert.lm_unstack(deq)
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        params, opt_state = opt.update(grads, opt_state,
                                       cnn_trainer.params_of(model))
        cnn_trainer.assign(model, params)
        return model, opt_state, err, loss

    return train_step


def init_error_state(model: lm.LM) -> dict[str, torch.Tensor]:
    """The compression's zero error carry, one f32 tensor per JAX leaf."""
    return compression.init_error_state(
        convert.lm_stack(cnn_trainer.params_of(model)))


def state_tree(model: lm.LM, opt_state: optim.OptState) -> dict:
    """``{"params": ..., "opt": OptState}`` as the JAX launcher saves it."""
    return {"params": convert.lm_tree(cnn_trainer.params_of(model)),
            "opt": convert.lm_opt_state_tree(opt_state)}


def load_state(ckpt, step: int, model: lm.LM) -> optim.OptState:
    """Restore checkpoint ``step`` (a `Checkpointer`'s, in the JAX
    layout) into ``model`` in place; return the restored AdamW state, on
    the model's device."""
    device = next(model.parameters()).device
    # the structure alone: `restore` reads only each leaf's device
    like = convert.lm_tree({k: torch.empty(0, device=device)
                            for k, _ in model.named_parameters()})
    state = ckpt.restore(step, {"params": like, "opt": optim.OptState(
        torch.empty(0, device=device), like, like)})
    cnn_trainer.assign(model, convert.lm_untree(state["params"]))
    return convert.lm_opt_state_untree(state["opt"])
