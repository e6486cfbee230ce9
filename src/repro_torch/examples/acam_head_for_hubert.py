"""The paper's technique at zoo scale: an ACAM template-matching head on the
HuBERT encoder (504 masked-prediction units: ACAM-scale classification).

The twin of the JAX package's `examples/acam_head_for_hubert.py`. It
trains the encoder (SMOKE by default, ``--full-width`` the 48-layer
config) with AdamW at 3e-3 on a synthetic frame-labelling task (16
classes: a frame's class is its nearest of 16 random directions), takes
its logits as the feature map, builds a ``generate_templates(k=1)`` bank
from a calibration batch, and compares the dense head's frame accuracy
with the `ACAMHead`'s, with the head's Eq. 14 energy per frame. The data
comes from a seeded numpy generator (the JAX example's `jax.random` bits
need JAX), drawn in bf16 as there; the features are the logits upcast to
f32. On the card the head runs B1 (`acam_match_classify`), one launch a
call.

    python -m repro_torch.examples.acam_head_for_hubert
    python -m repro_torch.examples.acam_head_for_hubert --full-width \\
        --steps 4

It runs on the card unless the caller asks for the CPU
(``main(argv, device="cpu")``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

N_CLASSES = 16  # a reduced codebook, as in the JAX example
SEED = 0  # the weights, the class directions and the frames


def frames(cfg, proto: torch.Tensor, step: int, *, b: int = 8, s: int = 32,
           device=None) -> dict:
    """A batch of (b, s) bf16 frame embeddings and their classes, the
    argmax of each frame's f32 product with the class directions ``proto``
    (computed on the CPU, so every device trains on the same labels)."""
    rng = np.random.default_rng([SEED, step])
    x = torch.from_numpy(rng.standard_normal(
        (b, s, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    y = torch.einsum("bsd,cd->bsc", x.float(), proto).argmax(dim=-1)
    return {"inputs": x.to(device), "labels": y.to(device)}


def features(model, cfg, x: torch.Tensor) -> torch.Tensor:
    """The encoder's logits as the feature map, (frames, vocab) in f32."""
    from repro_torch.models import lm

    with torch.no_grad():
        logits, _ = lm.forward(model, cfg, x)
    return logits.reshape(-1, cfg.vocab).float()


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-width", action="store_true",
                    help="hubert-xlarge's full config (default: SMOKE)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.core import hybrid, templates
    from repro_torch.device import resolve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.optim import optimizers as optim
    from repro_torch.train import cnn_trainer

    cnn_trainer.deterministic_cublas()  # before the first cuBLAS handle
    dev = resolve(device)
    cfg = configs.get("hubert-xlarge", smoke=not args.full_width)
    model = lm.init_params(SEED, cfg, device=dev)
    opt = optim.adamw(3e-3)
    opt_state = opt.init(cnn_trainer.params_of(model))
    proto = torch.from_numpy(np.random.default_rng([SEED, 9])
                             .standard_normal((N_CLASSES, cfg.d_model),
                                              dtype=np.float32))

    def batch(step, b=8):
        return frames(cfg, proto, step, b=b, device=dev)

    losses = []
    for i in range(args.steps):
        loss, grads = steps_lib.value_and_grad(model, cfg, batch(i))
        params, opt_state = opt.update(grads, opt_state,
                                       cnn_trainer.params_of(model))
        cnn_trainer.assign(model, params)
        losses.append(float(loss))
    print(f"encoder trained: final loss {losses[-1]:.3f}")

    test, cal = batch(999, b=16), batch(123, b=32)
    feats = features(model, cfg, test["inputs"])
    y = test["labels"].reshape(-1)
    acc_dense = float((feats.argmax(dim=-1) == y).float().mean())
    cal_feats = features(model, cfg, cal["inputs"])
    cal_y = cal["labels"].reshape(-1)
    bank = templates.generate_templates(cal_feats, cal_y, N_CLASSES, k=1)
    head = hybrid.ACAMHead(bank=bank)
    pred, per_class = head(feats)
    acc_acam = float((pred == y).float().mean())
    nj = head.energy_per_inference() * 1e9

    print(f"dense-head frame accuracy : {acc_dense:.4f}")
    print(f"ACAM-head frame accuracy  : {acc_acam:.4f}")
    print(f"ACAM energy per frame     : {nj:.3f} nJ ({N_CLASSES} templates "
          f"x {bank.num_features} cells x 185 fJ)")
    return dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                vocab=cfg.vocab, n_classes=N_CLASSES, losses=losses,
                final_loss=losses[-1] if losses else None,
                acc_dense=acc_dense, acc_acam=acc_acam, nj_per_frame=nj,
                features=feats, labels=y, cal_features=cal_feats,
                cal_labels=cal_y, head=head, pred=pred, per_class=per_class)


if __name__ == "__main__":
    main()
