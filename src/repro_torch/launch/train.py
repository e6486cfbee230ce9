"""Training launcher of the port: the JAX package's `repro.launch.train`.

Runs any of the zoo's ten architectures (the full config unless
``--smoke``) with the JAX launcher's flags and semantics:
  - checkpoint / restart in the JAX on-disk format (``{"params", "opt"}``,
    layers stacked; `launch.steps.state_tree`): ``--resume`` continues
    from the newest durable step, whichever package wrote it;
  - ``--grad-accum N``: N microbatches a step, each followed by its own
    optimizer update (the JAX launcher's loop); the step's loss is their
    mean;
  - ``--compress``: int8 error-feedback gradient compression; the error
    carry starts at zero on every launch (it is not checkpointed);
  - the weights are seeded random (seed 0), the data `synthetic_batch`,
    the JAX launcher's numpy stream.

It runs on the card unless the caller asks for the CPU
(``main(argv, device="cpu")``; the command line always means the card),
under PyTorch's deterministic algorithms (`launch.steps`). As in JAX, the
run installs a mesh for the model code (`context.set_mesh_axes`, cleared
at the end): the host mesh with fewer than 16 devices, else the
production mesh (`launch.mesh`). The devices are `context.devices`: every
card, or ``REPRO_FORCE_MESH=DxM`` copies of one (16x16 gives a production
mesh on one card). The step itself runs on the first device, as the JAX
launcher's jitted step does; the mesh reaches `layers.moe_shardmap`.

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 20
  python -m repro_torch.launch.train --arch hymba-1.5b --smoke \
      --steps 30 --ckpt-dir ckpt --ckpt-every 10
  python -m repro_torch.launch.train --arch hymba-1.5b --smoke \
      --steps 40 --ckpt-dir ckpt --resume
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.device import resolve
from repro_torch.distributed import context, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.train import cnn_trainer


def synthetic_batch(cfg: lm.ArchConfig, batch: int, seq: int, step: int, *,
                    device=None) -> dict:
    """The JAX launcher's deterministic synthetic stream (seeded by the
    step): int32 tokens, or bf16 embeddings for ``input_mode="embeds"``;
    int32 labels; the M-RoPE positions (3, B, S) where the config uses
    them. On ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve(device)
    rng = np.random.RandomState(step)
    if cfg.input_mode == "tokens":
        toks = rng.randint(0, cfg.vocab, size=(batch, seq), dtype=np.int64)
        inputs = torch.from_numpy(toks.astype(np.int32))
    else:
        inputs = torch.from_numpy(rng.randn(batch, seq, cfg.d_model)).to(
            torch.bfloat16)
    labels = torch.from_numpy(
        rng.randint(0, cfg.vocab, size=(batch, seq)).astype(np.int32))
    out = {"inputs": inputs.to(dev), "labels": labels.to(dev)}
    if cfg.rope == "mrope":
        pos = torch.arange(seq, dtype=torch.int32)[None, None].expand(
            3, batch, seq)
        out["positions"] = pos.to(dev)
    return out


def main(argv=None, *, device=None) -> dict:
    """Train; return ``{"losses", "final_loss"}`` (one loss a step, the
    mean over its microbatches) and ``step_s``, each step's wall time."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--async-ckpt", action="store_true")
    args = ap.parse_args(argv)
    cnn_trainer.deterministic_cublas()  # before the first cuBLAS handle
    dev = resolve(device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    mesh = mesh_lib.make_host_mesh(dev) if len(context.devices(dev)) < 16 \
        else mesh_lib.make_production_mesh(device=dev)
    context.set_mesh_axes(sharding.dp_axes(mesh), "model", mesh=mesh)
    try:
        return _train(args, cfg, dev)
    finally:
        context.clear()


def _train(args, cfg, dev) -> dict:
    opt = steps_lib.make_optimizer(cfg, args.lr)
    train_step = steps_lib.make_train_step(cfg, opt, compress=args.compress)

    model = lm.init_params(0, cfg, device=dev)
    opt_state = opt.init(cnn_trainer.params_of(model))
    err = steps_lib.init_error_state(model) if args.compress else None
    step0 = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            opt_state = steps_lib.load_state(ckpt, latest, model)
            step0 = latest + 1
            print(f"resumed from step {latest}")

    losses, step_s = [], []
    for step in range(step0, args.steps):
        t0 = time.time()
        loss_acc = 0.0
        for micro in range(args.grad_accum):
            batch = synthetic_batch(cfg, args.batch, args.seq,
                                    step * args.grad_accum + micro,
                                    device=dev)
            model, opt_state, err, loss = train_step(model, opt_state, err,
                                                     batch)
            loss_acc += float(loss)
        losses.append(loss_acc / args.grad_accum)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step, steps_lib.state_tree(model, opt_state),
                      blocking=not args.async_ckpt)
        step_s.append(time.time() - t0)
        print(f"step {step}: loss={losses[-1]:.4f} ({step_s[-1]:.2f}s)")
    if ckpt:
        ckpt.save(args.steps - 1, steps_lib.state_tree(model, opt_state))
        ckpt.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "step_s": step_s}


if __name__ == "__main__":
    main()
