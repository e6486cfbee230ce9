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
in the JAX launcher's layout.

The sharded builders (`build_train_step`, `build_prefill_step`,
`build_decode_step`) are the JAX ones on a `context.Mesh`: each returns
``(fn, in_specs, out_specs[, opt])``, the specs of
`repro_torch.distributed.sharding`, fitted to ``example_batch`` /
``example_args`` as in JAX. ``fn`` takes the model stored on the mesh
(`sharding.shard_model`) and its operands as tensors or `ShardedTensor`s
(placed by the in-specs first, as jit's in-shardings do) and returns
sharded outputs laid out by the out-specs. Parameters, moments and the
decode cache are updated in place where JAX donates them. One controller
runs every data coordinate's rows on its device in turn
(`sharding` says how); the MoE's load-balance loss and capacity are the
global batch's, as in JAX's global function. A 1x1 mesh gives
`make_train_step`'s result.

The dry run's probes (`build_layer_probe`, `build_embed_head_probe`) are
the JAX ones too: one layer, or the embedding, final norm and head, at a
cell's shapes and shardings, with and without the gradient; each returns
``(probe, args, in_specs)``, ``args`` meta tensors, and the probe runs as
well on CPU or CUDA tensors of the same shapes.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable

import torch

from repro_torch import convert
from repro_torch.distributed import context
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, ShardedTensor
from repro_torch.models import cnn, lm
from repro_torch.models import layers as L
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


# ---------------------------------------------------------------------------
# the sharded builders
# ---------------------------------------------------------------------------

def _placed(tree, specs, mesh):
    """Operands as `ShardedTensor`s: a tensor is placed by its spec, a
    sharded one by another spec re-placed (jit's in-shardings)."""
    def put(spec, x):
        if x is None:
            return None
        if isinstance(x, ShardedTensor) and tuple(x.spec) == tuple(spec):
            return x
        return sharding.NamedSharding(mesh, spec).place(
            x.full() if isinstance(x, ShardedTensor) else torch.as_tensor(x))
    return sharding.tree_map(put, specs, tree)


def _coordinates(rows: ShardedTensor, axis: int, mesh) -> list:
    """The data coordinates that compute, in dp order, with the rows
    (slice of ``axis``) each holds: one per distinct row block (a batch
    the dp axes do not cut is computed once, by dp index 0)."""
    ranks = mesh.ranks(sharding.dp_axes(mesh), "model")
    seen, out = set(), []
    for i, row in enumerate(ranks):
        sl = rows.index[row[0]][axis]
        if (sl.start, sl.stop) not in seen:
            seen.add((sl.start, sl.stop))
            out.append((i, sl))
    return out


def _shard(mesh, i: int, tokens: int, prefix: dict) -> context.DataShard:
    ranks = mesh.ranks(sharding.dp_axes(mesh), "model")
    dev = mesh.devices[ranks[i][0]]
    return context.DataShard(i, mesh, ranks[i], tokens, sharding.placer(dev),
                             prefix=dict(prefix))


def _add_counts(prefix: dict, shard: context.DataShard) -> None:
    """The expert counts of ``shard`` added to the running prefix."""
    for layer, (counts, _, _) in shard.moe.items():
        c = counts.to(torch.int64)
        prefix[layer] = c if layer not in prefix else \
            prefix[layer].to(c.device) + c


def _read(x: ShardedTensor | None, rows: slice, axis: int, device):
    if x is None:
        return None
    return x.read((slice(None),) * axis + (rows,), device)


def _full_region(shape: tuple, rows: slice, axis: int) -> tuple:
    return tuple(rows if a == axis else slice(0, n)
                 for a, n in enumerate(shape))


def mesh_loss(params: lm.LM, cfg: lm.ArchConfig, mesh, batch: dict,
              *, backward: bool = False) -> torch.Tensor:
    """`lm.loss_fn` of the global batch, each data coordinate's rows on
    its device: the CE summed per coordinate and divided once by the
    global count of labels >= 0, plus each MoE layer's load-balance loss
    from the global batch's expert counts and mean router probabilities.
    With ``backward`` each coordinate's share of the loss is
    differentiated in turn (coordinate 0 first), adding into the storage
    blocks' ``.grad``. Returns the loss (on the first coordinate's
    device)."""
    coords = _coordinates(batch["labels"], 0, mesh)
    b, s = batch["labels"].shape
    tokens, prefix, runs = b * s, {}, []
    for i, rows in coords:
        shard = _shard(mesh, i, tokens, prefix)
        dev = shard.device
        with context.running(shard):
            logits, _ = lm.forward(
                params, cfg, _read(batch["inputs"], rows, 0, dev),
                _read(batch.get("positions"), rows, 1, dev))
            labels = _read(batch["labels"], rows, 0, dev)
            if cfg.causal:
                logits, labels = logits[:, :-1], labels[:, 1:]
            mask = labels >= 0
            nll = (lm.sharded_ce(logits, labels) * mask).sum()
        _add_counts(prefix, shard)
        runs.append((shard, nll, mask.sum()))
    home = runs[0][0].device
    for shard, nll, c in runs[1:]:  # the sums over the coordinates
        sharding.record_collective("all-reduce", sum(
            x.numel() * x.element_size() for x in (
                nll, c, *(t for m in shard.moe.values() for t in m[:2]))),
            shard.ranks[0])
    count = torch.clamp_min(sum(c.to(home) for _, _, c in runs), 1)
    frac = _moe_fractions([sh for sh, _, _ in runs], tokens, home)
    if backward:
        for shard, nll, _ in runs:
            with context.running(shard):
                part = nll / count.to(shard.device) + _aux_share(
                    frac, shard, tokens)
                part.backward()
    with torch.no_grad():
        loss = sum(nll.detach().to(home) for _, nll, _ in runs) / count
        for layer, (f, coeff) in frac.items():
            psum = sum(sh.moe[layer][1].detach().to(home)
                       for sh, _, _ in runs)
            loss = loss + coeff * f.numel() * (f * (psum / tokens)).sum()
    return loss


def _moe_fractions(shards: list, tokens: int, home) -> dict:
    """Each MoE layer's (dispatch fraction over the global batch,
    load-balance coefficient), from the coordinates' expert counts."""
    frac = {}
    for layer in sorted(shards[0].moe):
        counts = sum(sh.moe[layer][0].to(home) for sh in shards)
        frac[layer] = (counts / tokens, shards[0].moe[layer][2])
    return frac


def _aux_share(frac: dict, shard: context.DataShard, tokens: int
               ) -> torch.Tensor:
    """``shard``'s differentiable share of the global batch's MoE
    load-balance loss: the shares of all coordinates sum to it."""
    dev = shard.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for layer, (f, coeff) in frac.items():
        psum = shard.moe[layer][1]
        total = total + coeff * f.numel() * (
            f.to(dev) * (psum / tokens)).sum()
    return total


def _owned(params: lm.LM) -> dict[str, torch.Tensor]:
    """Each parameter's owner blocks, keyed ``name@coord``: the tensors the
    gradients add into and the update writes."""
    return {f"{name}@{c}": st.blocks[c]
            for name, st in sharding.sharded_tensors(params).items()
            for c in st.owners()}


def init_mesh_opt_state(params: lm.LM) -> optim.OptState:
    """AdamW's zero state for a sharded model: f32 moments laid out as the
    parameters, the step counter replicated."""
    tensors = sharding.sharded_tensors(params)
    mesh = next(iter(tensors.values())).mesh

    def zeros(st):
        return st.sharding.place(torch.zeros(st.shape, dtype=torch.float32,
                                             device=st.mesh.devices.flat[0]),
                                 st.path)
    mu = {k: zeros(st) for k, st in tensors.items()}
    nu = {k: zeros(st) for k, st in tensors.items()}
    step = sharding.NamedSharding(mesh, P()).place(
        torch.zeros((), dtype=torch.int32, device=mesh.devices.flat[0]))
    return optim.OptState(step, mu, nu)


def _mesh_update(opt: optim.Optimizer, params: lm.LM,
                 opt_state: optim.OptState, grads: dict) -> torch.Tensor:
    """Clip at global norm 1.0 over the owner blocks, then AdamW block by
    block, written into the owner blocks in place and copied to their
    copies. Returns the norm."""
    tensors = sharding.sharded_tensors(params)
    owned = _owned(params)
    home = next(iter(tensors.values())).mesh.devices.flat[0]
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())).to(home)
                          for g in grads.values()))
    scale = torch.clamp(1.0 / (norm + 1e-9), max=1.0)
    mu, nu = _owned_tree(opt_state.mu), _owned_tree(opt_state.nu)
    steps = {str(b.device): b for b in opt_state.step.blocks.values()}
    with torch.no_grad():
        # one block at a time: the clip's and the update's temporaries
        # stay one block's
        for k, p in owned.items():
            g = grads[k]
            g = g.to(torch.promote_types(g.dtype, scale.dtype)) * scale.to(
                g.device)
            new, st = opt.update({k: g}, optim.OptState(
                steps[str(p.device)], {k: mu[k]}, {k: nu[k]}), {k: p})
            p.copy_(new[k])
            mu[k].copy_(st.mu[k])
            nu[k].copy_(st.nu[k])
        for blk in opt_state.step.blocks.values():
            blk.add_(1)
        for tree in (tensors, opt_state.mu, opt_state.nu):
            for st in tree.values():
                st.sync()
    return norm


def _owned_tree(tree: dict[str, ShardedTensor]) -> dict:
    return {f"{name}@{c}": st.blocks[c] for name, st in tree.items()
            for c in st.owners()}


def build_train_step(cfg: lm.ArchConfig, mesh, *, mode: str = "fsdp_tp",
                     lr: float = 3e-4, example_batch=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss and its gradient over the mesh (`mesh_loss`),
    clipping at global norm 1.0, AdamW (``opt.init`` makes its state on
    the mesh). The parameters and moments are updated in place, where JAX
    donates them."""
    register = sharding.register_zero3_constraints
    register(cfg, mesh, mode)
    opt = make_optimizer(cfg, lr)
    opt = optim.Optimizer(init_mesh_opt_state, opt.update)
    p_specs = sharding.param_specs(cfg, mesh, mode)
    o_specs = sharding.opt_state_specs(p_specs)
    b_specs = sharding.batch_specs(cfg, mesh)
    if example_batch is not None:
        b_specs = sharding.fit_tree(b_specs, example_batch, mesh)
    metric_specs = {"loss": P(), "grad_norm": P()}
    in_specs = (p_specs, o_specs, b_specs)
    out_specs = (p_specs, o_specs, metric_specs)

    def train_step(params, opt_state, batch):
        register(cfg, mesh, mode)
        batch = _placed({k: batch[k] for k in b_specs}, b_specs, mesh)
        owned = _owned(params)
        home = next(iter(owned.values())).device
        for blk in owned.values():
            blk.requires_grad_(True)
        try:
            with torch.enable_grad(), cnn.fp32(home), \
                    cnn_trainer.deterministic(home):
                loss = mesh_loss(params, cfg, mesh, batch, backward=True)
            grads = {k: torch.zeros_like(b) if b.grad is None else b.grad
                     for k, b in owned.items()}
        finally:
            for blk in owned.values():
                blk.grad = None
                blk.requires_grad_(False)
        gnorm = _mesh_update(opt, params, opt_state, grads)
        metrics = {"loss": loss, "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step, in_specs, out_specs, opt


def _cache_shapes(cfg: lm.ArchConfig, b: int, max_len: int) -> lm.Cache:
    return lm.init_cache(cfg, b, max_len, device="meta")


def build_prefill_step(cfg: lm.ArchConfig, mesh, *, mode: str = "fsdp_tp",
                       max_len: int | None = None, example_args=None):
    """prefill(params, inputs[, positions]) -> (last_logits, cache), the
    cache laid out by `sharding.cache_specs`."""
    sharding.register_zero3_constraints(cfg, mesh, mode)
    dp = sharding.dp_axes(mesh)
    p_specs = sharding.param_specs(cfg, mesh, mode)
    in_sp: tuple = (p_specs, P(dp, None, None) if cfg.input_mode == "embeds"
                    else P(dp, None))
    if cfg.rope == "mrope":
        in_sp += (P(None, dp, None),)
    out_sp = (P(dp, "model"), sharding.cache_specs(cfg, mesh))
    if example_args is not None:
        # the parameter specs come fitted; example_args[0] may be a model
        in_sp = (p_specs,) + sharding.fit_tree(in_sp[1:], example_args[1:],
                                               mesh)
        b, s = example_args[1].shape[:2]
        length = max_len or s
        out_shapes = (torch.empty((b, cfg.vocab), device="meta"),
                      _cache_shapes(cfg, b, length if cfg.sliding_window
                                    else max(length, s)))
        out_sp = sharding.fit_tree(out_sp, out_shapes, mesh)

    @torch.no_grad()
    def prefill_step(params, inputs, positions=None):
        sharding.register_zero3_constraints(cfg, mesh, mode)
        inputs = _placed(inputs, in_sp[1], mesh)
        if positions is not None:
            positions = _placed(positions, in_sp[2], mesh)
        b, s = inputs.shape[:2]
        logit_parts, cache_parts, prefix = [], [], {}
        cache = None
        for i, rows in _coordinates(inputs, 0, mesh):
            shard = _shard(mesh, i, b * s, prefix)
            with context.running(shard):
                logits, cache = lm.prefill(
                    params, cfg, _read(inputs, rows, 0, shard.device),
                    _read(positions, rows, 1, shard.device),
                    max_len=max_len)
            _add_counts(prefix, shard)
            logit_parts.append(((rows, slice(0, cfg.vocab)), logits))
            cache_parts.append((rows, cache))
        logits = ShardedTensor.assemble(out_sp[0], mesh, (b, cfg.vocab),
                              logit_parts[0][1].dtype, logit_parts)
        fields = {}
        for f in lm.CACHE_FIELDS:
            x = getattr(cache, f)
            if x is None:
                continue
            shape = (x.shape[0], b, *x.shape[2:])
            fields[f] = ShardedTensor.assemble(
                getattr(out_sp[1], f), mesh, shape, x.dtype,
                [(_full_region(shape, rows, 1), getattr(c, f))
                 for rows, c in cache_parts])
        return logits, cache._replace(**fields)

    return prefill_step, in_sp, out_sp


def build_decode_step(cfg: lm.ArchConfig, mesh, *, mode: str = "fsdp_tp",
                      example_args=None):
    """decode(params, tokens, cache) -> (logits, cache): the cache's blocks
    updated in place (JAX donates it)."""
    sharding.register_zero3_constraints(cfg, mesh, mode)
    dp = sharding.dp_axes(mesh)
    p_specs = sharding.param_specs(cfg, mesh, mode)
    tok_sp = P(dp, None, None) if cfg.input_mode == "embeds" else P(dp, None)
    cache_sp = sharding.cache_specs(cfg, mesh)
    in_sp = (p_specs, tok_sp, cache_sp)
    out_sp = (P(dp, None, "model"), cache_sp)
    if example_args is not None:
        # the parameter specs come fitted; example_args[0] may be a model
        in_sp = (p_specs,) + sharding.fit_tree(in_sp[1:], example_args[1:],
                                               mesh)
        b = example_args[1].shape[0]
        out_shapes = (torch.empty((b, 1, cfg.vocab), device="meta"),
                      example_args[2])
        out_sp = sharding.fit_tree(out_sp, out_shapes, mesh)

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        sharding.register_zero3_constraints(cfg, mesh, mode)
        tokens = _placed(tokens, in_sp[1], mesh)
        cache = cache._replace(**{
            f: _placed(getattr(cache, f), getattr(in_sp[2], f), mesh)
            for f in lm.CACHE_FIELDS if getattr(cache, f) is not None})
        b = tokens.shape[0]
        parts, prefix = [], {}
        for i, rows in _coordinates(tokens, 0, mesh):
            shard = _shard(mesh, i, b, prefix)
            dev = shard.device
            local = cache._replace(**{
                f: _read(getattr(cache, f), rows, 1, dev)
                for f in lm.CACHE_FIELDS if getattr(cache, f) is not None})
            with context.running(shard):
                logits, local = lm.decode_step(
                    params, cfg, _read(tokens, rows, 0, dev), local)
            _add_counts(prefix, shard)
            for f in lm.CACHE_FIELDS:
                st = getattr(cache, f)
                if st is not None:
                    st.write(_full_region(st.shape, rows, 1),
                             getattr(local, f))
            parts.append(((rows, slice(0, 1), slice(0, cfg.vocab)), logits))
        logits = ShardedTensor.assemble(out_sp[0], mesh, (b, 1, cfg.vocab),
                              parts[0][1].dtype, parts)
        return logits, cache._replace(length=cache.length + 1)

    return decode_step, in_sp, out_sp


# ---------------------------------------------------------------------------
# per-layer probes (the dry run's roofline terms; see launch/dryrun.py)
# ---------------------------------------------------------------------------

class Probe:
    """A probe function: ``probe(*args, only=None)``. Tensors and modules
    among ``args`` are placed on the mesh by the probe's in-specs first,
    as jit's in-shardings place them (`place` does only that, so a caller
    can place outside what it measures); ``only`` restricts the run to
    those data coordinates (dp indices), the dry run's one coordinate."""

    def __init__(self, place: Callable, run: Callable):
        self._place, self._run = place, run

    def place(self, *args) -> tuple:
        return self._place(*args)

    def __call__(self, *args, only=None):
        return self._run(*self._place(*args), only=only)


def _meta_model(cfg: lm.ArchConfig, n_layers: int) -> lm.LM:
    return lm.init_params(0, dataclasses.replace(cfg, n_layers=n_layers),
                          device="meta")


def _place_module(module, tree: dict, mesh, prefix: str):
    """A module's parameters placed by the JAX spec ``tree`` (a module
    already placed passes through); an MoE learns its layer index."""
    if next(module.parameters(), None) is None:
        return module
    out = sharding.shard_module(module, tree, mesh, prefix)
    if getattr(out, "moe", None) is not None:
        out.moe.layer = 0
    return out


def _module_specs(module, tree: dict, prefix: str) -> dict:
    return {name: sharding.leaf_spec(tree, prefix + name)
            for name, _ in module.named_parameters()}


def _grad_of(st: ShardedTensor) -> ShardedTensor:
    """The gradient accumulated into ``st``'s owner blocks, laid out as
    ``st`` (copies share their owner's gradient)."""
    owner = {tuple((sl.start, sl.stop) for sl in idx): c
             for c, idx in st.owners().items()}
    blocks = {}
    for c, idx in st.index.items():
        blk = st.blocks[owner[tuple((sl.start, sl.stop) for sl in idx)]]
        blocks[c] = torch.zeros_like(blk) if blk.grad is None else blk.grad
    return ShardedTensor(st.sharding, st.shape, st.dtype, blocks, st.path)


@contextlib.contextmanager
def _differentiating(tensors: list[ShardedTensor], on: bool):
    """Grad mode (``on``) with the owner blocks of ``tensors`` requiring
    grad, their ``.grad`` dropped after."""
    blocks = [st.blocks[c] for st in tensors for c in st.owners()] \
        if on else []
    for blk in blocks:
        blk.requires_grad_(True)
    try:
        with torch.set_grad_enabled(on), L.true_f32():
            yield
    finally:
        for blk in blocks:
            blk.grad = None
            blk.requires_grad_(False)


def _joined(parts: list) -> torch.Tensor:
    """The coordinates' outputs, rows in dp order, on the first one's
    device (one coordinate's output as it is)."""
    if len(parts) == 1:
        return parts[0]
    home = parts[0].device
    return torch.cat([x.to(home) for x in parts])


def build_layer_probe(cfg: lm.ArchConfig, mesh, *, kind: str, seq: int,
                      batch: int, mode: str = "fsdp_tp", with_grad: bool
                      ) -> tuple[Probe, tuple, tuple]:
    """A single layer at a cell's shapes and shardings -> (probe, args,
    in_specs), ``args`` meta tensors (a meta `lm.Layer` first).

    kind: "train" / "prefill" run the full-sequence layer (with
    ``with_grad``: ``sum(out) + aux`` differentiated for the layer's
    parameters and ``h``, as ``jax.grad`` of JAX's probe; returns
    (parameter name -> gradient, gradient of h), laid out as their
    operands), else the layer's output; "decode" the single-token layer
    (`lm._layer_decode`) at ``length = seq - 1`` with this layer's cache
    slices, updated in place -> (output, cache slices). Each data
    coordinate runs its rows (batch / dp) on its device with the ZeRO-3
    hooks installed, as a mesh step does; the MoE's capacity and its
    load-balance loss are the global batch's. The rope tables are inputs
    where ``cfg.precompute_rope`` applies (the real model builds them once
    a step). The census of the probe, times n_layers, is the layers' cost
    (see `repro_torch.launch.dryrun`)."""
    sharding.register_zero3_constraints(cfg, mesh, mode)
    dp = sharding.dp_axes(mesh)
    tree = sharding.param_specs(cfg, mesh, mode)
    prefix = "layers.0."
    layer = _meta_model(cfg, 1).layers[0]
    layer_sp = _module_specs(layer, tree, prefix)
    use_tabs = (cfg.precompute_rope and cfg.rope == "standard"
                and cfg.uses_attention)
    tab_d = (cfg.qk_rope_dim if cfg.mla else cfg.head_dim) // 2

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        args: tuple = (layer, meta((batch, seq, cfg.d_model), cfg.dtype))
        rest: tuple = (P(dp, None, None),)
        if use_tabs:
            args += (meta((batch, seq, tab_d), torch.float32),) * 2
            rest += (P(dp, None, None),) * 2
        in_sp = (layer_sp,) + sharding.fit_tree(rest, args[1:], mesh)

        def place(layer, h, *tabs):
            return (_place_module(layer, tree, mesh, prefix),
                    *(_placed(x, sp, mesh)
                      for x, sp in zip((h, *tabs), in_sp[1:])))

        def run(layer, h, *tabs, only=None):
            b, s = h.shape[:2]
            params = list(sharding.sharded_tensors(layer).values())
            runs, prefix_counts = [], {}
            with _differentiating(params + [h], with_grad):
                for i, rows in _coordinates(h, 0, mesh):
                    if only is not None and i not in only:
                        continue
                    shard = _shard(mesh, i, b * s, prefix_counts)
                    dev = shard.device
                    with context.running(shard):
                        hh = _read(h, rows, 0, dev)
                        t = tuple(_read(x, rows, 0, dev) for x in tabs)
                        pos = lm._default_positions(cfg, hh.shape[0], s,
                                                    device=dev)
                        out, _ = lm._layer_train(layer, cfg, hh, pos,
                                                 t or None)
                    _add_counts(prefix_counts, shard)
                    runs.append((shard, out))
                if not with_grad:
                    return _joined([out for _, out in runs])
                frac = _moe_fractions([sh for sh, _ in runs], b * s,
                                      runs[0][0].device)
                for shard, out in runs:
                    with context.running(shard):
                        part = torch.sum(out.to(torch.float32)) + \
                            _aux_share(frac, shard, b * s)
                        part.backward()
                return ({name: _grad_of(st) for name, st in
                         sharding.sharded_tensors(layer).items()},
                        _grad_of(h))

        return Probe(place, run), args, in_sp

    # decode: one token against this layer's cache slices
    cache = lm.init_cache(cfg, batch, seq, device="meta")
    fields = lm._cache_layer_fields(cfg)
    cache_l = {f: meta(getattr(cache, f).shape[1:], getattr(cache, f).dtype)
               for f in fields}
    full_cache_sp = sharding.cache_specs(cfg, mesh)
    cache_l_sp = {f: getattr(full_cache_sp, f)[1:] for f in fields}
    args = (layer, meta((batch, 1, cfg.d_model), cfg.dtype), cache_l)
    in_sp = (layer_sp,) + sharding.fit_tree(
        (P(dp, None, None), cache_l_sp), args[1:], mesh)

    def place(layer, h, cache_l):
        return (_place_module(layer, tree, mesh, prefix),
                _placed(h, in_sp[1], mesh),
                {f: _placed(x, in_sp[2][f], mesh)
                 for f, x in cache_l.items()})

    @torch.no_grad()
    def run(layer, h, cache_l, only=None):
        b = h.shape[0]
        parts, prefix_counts = [], {}
        with L.true_f32():
            for i, rows in _coordinates(h, 0, mesh):
                if only is not None and i not in only:
                    continue
                shard = _shard(mesh, i, b, prefix_counts)
                dev = shard.device
                with context.running(shard):
                    local = {f: _read(st, rows, 0, dev)
                             for f, st in cache_l.items()}
                    out, local = lm._layer_decode(
                        layer, cfg, _read(h, rows, 0, dev), local, seq - 1)
                    for f, st in cache_l.items():
                        st.write(_full_region(st.shape, rows, 0), local[f])
                _add_counts(prefix_counts, shard)
                parts.append(out)
        return _joined(parts), cache_l

    return Probe(place, run), args, in_sp


def build_embed_head_probe(cfg: lm.ArchConfig, mesh, *, kind: str, seq: int,
                           batch: int, mode: str = "fsdp_tp",
                           with_grad: bool) -> tuple[Probe, tuple, tuple]:
    """Embedding + final norm + unembed -> (probe, args, in_specs), args
    (a meta `lm.LM` without layers, inputs, labels). ``kind="train"``
    gives ``mean(sharded_ce(logits, labels))`` and, with ``with_grad``,
    its gradient for the head's parameters (name -> gradient, laid out as
    the parameter), as ``jax.grad`` of JAX's head; other kinds
    ``sum(logits)`` in f32. Each data coordinate runs its rows, as in
    `build_layer_probe`."""
    sharding.register_zero3_constraints(cfg, mesh, mode)
    dp = sharding.dp_axes(mesh)
    tree = sharding.param_specs(cfg, mesh, mode)
    head = _meta_model(cfg, 0)
    head_sp = _module_specs(head, tree, "")
    s = seq if kind != "decode" else 1
    if cfg.input_mode == "embeds":
        inp = torch.empty((batch, s, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
        inp_sp = P(dp, None, None)
    else:
        inp = torch.empty((batch, s), dtype=torch.int32, device="meta")
        inp_sp = P(dp, None)
    lbl = torch.empty((batch, s), dtype=torch.int32, device="meta")
    in_sp = (head_sp,) + sharding.fit_tree((inp_sp, P(dp, None)),
                                           (inp, lbl), mesh)
    grad = with_grad and kind == "train"

    def place(params, inputs, labels):
        if len(params.layers):  # a whole model: its head's leaves alone
            params = copy.copy(params)
            params._modules = dict(params._modules,
                                   layers=torch.nn.ModuleList())
        return (_place_module(params, tree, mesh, ""),
                _placed(inputs, in_sp[1], mesh),
                _placed(labels, in_sp[2], mesh))

    def run(params, inputs, labels, only=None):
        b, s_ = inputs.shape[:2]
        tensors = list(sharding.sharded_tensors(params).values())
        parts = []
        with _differentiating(tensors, grad):
            for i, rows in _coordinates(inputs, 0, mesh):
                if only is not None and i not in only:
                    continue
                shard = _shard(mesh, i, b * s_, {})
                dev = shard.device
                with context.running(shard):
                    p = lm._head_params(params)
                    h = lm._embed_in(p, cfg, _read(inputs, rows, 0, dev))
                    h = L.rmsnorm(p.final_norm, h)
                    logits = L.linear(p.unembed, h)
                    if kind == "train":
                        part = lm.sharded_ce(
                            logits, _read(labels, rows, 0, dev)).sum() / (
                            b * s_)
                    else:
                        part = torch.sum(logits.to(torch.float32))
                    if grad:
                        part.backward()
                parts.append(part.detach())
            if grad:
                return {name: _grad_of(st) for name, st in
                        sharding.sharded_tensors(params).items()}
        home = parts[0].device
        return sum(x.to(home) for x in parts)

    return Probe(place, run), (head, inp, lbl), in_sp
