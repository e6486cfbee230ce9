"""Sharding rules of the LM zoo, and the port's sharded tensors: the JAX
package's `repro/distributed/sharding.py`.

Mesh axes (`repro_torch.launch.mesh`): one pod ("data", "model") = (16,
16); two pods ("pod", "data", "model") = (2, 16, 16). "model" is the
tensor / expert-parallel axis; ("pod", "data") is the data-parallel and
FSDP axis. Two rule sets:

  tp      — parameters sharded over "model" only (copies across data);
  fsdp_tp — also the non-TP weight axis over ("pod", "data") (ZeRO-3).

The rules go by the parameter's path in the JAX tree (layers stacked on
axis 0, the leaf names of `repro_torch.convert.lm_tree`), so they are
plain data: `param_specs`, `opt_state_specs`, `batch_specs` and
`cache_specs` give the JAX specs leaf by leaf, from shapes alone (the
model built on the meta device, `lm.init_params(..., device="meta")`), at
any width. A per-layer tensor of the port takes its stacked leaf's spec
without the leading None.

How the mesh runs: one controller. A `context.Mesh` is a grid of
`torch.device`s and one process drives all of it, as the engine's
bank-sharded calls do; nothing here uses `torch.distributed` (NCCL takes
no two ranks on one card, and a forced mesh repeats one device):

  - *placing* a tensor by a `NamedSharding` gives a `ShardedTensor`: one
    block per mesh coordinate, on that coordinate's device; block (i, j[,
    k]) is exactly the slice that JAX's
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives device
    (i, j[, k]), and the mesh axes the spec leaves out hold copies;
  - *storage*: the parameters and both AdamW moments are stored by
    `param_specs` (`opt_state_specs`), the batch cut by `batch_specs`, a
    cache laid out by `cache_specs`; the step counter is replicated;
  - *compute*: each data-parallel coordinate runs its batch rows on its
    device (its model rank 0's). A layer's weights are gathered at use
    (`context.constrain_layer`): the ZeRO-3 hook of
    `register_zero3_constraints` re-specs them from the storage rules to
    the "tp" compute rules, then the coordinate places each whole on its
    device. The gather reads each distinct block once, from the first
    coordinate holding it, with differentiable ops, so autograd's
    backward *is* the reduce-scatter into the storage blocks; the
    coordinates' gradients add into those blocks one coordinate after
    another, a fixed order, and the copies are refreshed from them after
    the update;
  - *the model axis* splits compute where the JAX program names a rank:
    `layers.moe_shardmap`'s local experts and its combine over "model".
    Elsewhere GSPMD may split a dense product over "model" as it likes;
    the port computes such a product whole on the data coordinate's
    device, the same function (tensor-parallel dense products are a
    ROADMAP item: a virtual mesh on one card cannot measure them).

`validate_divisibility` reports what JAX's does; a `NamedSharding` that
does not divide its tensor raises, as JAX's does.

What crosses between coordinates is counted where it is read, not where
a device copies it (on a forced mesh every coordinate is one device and
``.to()`` copies nothing): inside `recording_collectives`, each read of
a `ShardedTensor` block that another coordinate owns (the ZeRO-3
gathers, a decode step's cache rows), `layers.moe_shardmap`'s combine
over "model" and the mesh loss's sums are logged as ``(coordinate,
kind, bytes)``, the coordinate being the data coordinate that reads
(`context.data_shard`). `repro_torch.analysis.census` reads the log.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch.distributed import context
from repro_torch.distributed.context import Mesh
from repro_torch.models import lm
from repro_torch.optim import optimizers as optim

PyTree = Any


class P(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor axis, each a
    mesh axis name, a tuple of names (the first major) or None; a tuple of
    one name is that name, as JAX normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getitem__(self, i):
        out = tuple.__getitem__(self, i)
        return P(*out) if isinstance(i, slice) else out


def dp_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def param_spec(names: list[str], ndim: int, *, mode: str, fsdp) -> P:
    """PartitionSpec for one param leaf addressed by its tree path."""
    w = fsdp if mode == "fsdp_tp" else None
    in_layers = names[0] == "layers"
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""

    def wrap(*spec):
        # prepend the stacked-layer axis
        return P(*(((None,) + spec) if in_layers else spec))

    # --- non-layer leaves ---
    if not in_layers:
        if names[0] == "embed":
            return P(None, "model")  # (V, d)
        if names[0] == "unembed":
            return P(w, "model") if leaf == "w" else P("model")
        return P(None)  # final_norm etc.

    # --- norms / scalars ---
    if leaf in ("scale", "bias") or parent.endswith("norm") or leaf in (
            "A_log", "D", "dt_bias", "conv_w"):
        return wrap(*([None] * (ndim - 1)))

    # --- MoE experts: E over "model" (expert parallelism) ---
    if parent == "moe" or (len(names) >= 3 and names[-3] == "moe"):
        if parent == "router":
            return wrap(w, None)  # (d, E)
        if leaf in ("gate", "up"):
            return wrap("model", w, None)  # (E, d, f)
        if leaf == "down":
            return wrap("model", None, w)  # (E, f, d)
        # shared expert (mlp-shaped)
        if parent in ("gate", "up"):
            return wrap(w, "model") if leaf == "w" else wrap("model")
        if parent == "down":
            return wrap("model", w) if leaf == "w" else wrap(w)

    # --- attention ---
    if parent in ("q", "k", "v"):
        return wrap(w, "model") if leaf == "w" else wrap("model")
    if parent == "o":
        return wrap("model", w) if leaf == "w" else wrap(w)
    # MLA projections
    if parent in ("q_a", "kv_a"):
        return wrap(w, None) if leaf == "w" else wrap(None)
    if parent in ("q_b", "kv_b"):
        return wrap(w, "model") if leaf == "w" else wrap("model")

    # --- dense MLP ---
    if parent in ("gate", "up"):
        return wrap(w, "model") if leaf == "w" else wrap("model")
    if parent == "down":
        return wrap("model", w) if leaf == "w" else wrap(w)

    # --- SSM (mamba2 / hymba): packed projections, FSDP only ---
    if parent == "in_proj":
        return wrap(w, None) if leaf == "w" else wrap(None)
    if parent == "out_proj":
        return wrap(None, w) if leaf == "w" else wrap(w)

    return wrap(*([None] * (ndim - 1)))


def _axis_size(mesh: Mesh, axis) -> int:
    axes = axis if isinstance(axis, tuple) else (axis,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def fit_spec(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
    """Drop sharding on axes whose size does not divide the mesh extent
    (mamba2's vocab 50280 % 16, hymba's 32001, hubert's 504, batch 1)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*(None if axis is None or dim % _axis_size(mesh, axis)
               else axis for dim, axis in zip(shape, entries)))


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree, *rest, is_leaf=_is_spec):
    """``jax.tree_util.tree_map`` over dicts, lists, tuples and
    NamedTuples; None stays None."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(getattr(r, f) for r in rest),
                                     is_leaf=is_leaf)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _shape(x) -> tuple:
    if isinstance(x, (int, float)):
        return ()  # a Python scalar (the cache's length)
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def fit_tree(specs: PyTree, shapes: PyTree, mesh: Mesh) -> PyTree:
    """`fit_spec` over a tree of specs and the matching tensors (or
    anything with a ``shape``)."""
    return tree_map(lambda s, x: fit_spec(s, _shape(x), mesh), specs, shapes)


@functools.lru_cache(maxsize=16)
def param_shapes(cfg: lm.ArchConfig) -> dict[str, torch.Tensor]:
    """The JAX tree's leaves, dotted paths -> meta tensors (shape and
    dtype, no memory), layers stacked on axis 0."""
    from repro_torch import convert

    model = lm.init_params(0, cfg, device="meta")
    return convert.lm_stack(dict(model.named_parameters()))


def _flat_specs(cfg: lm.ArchConfig, mesh: Mesh, mode: str) -> dict[str, P]:
    fsdp = dp_axes(mesh)
    return {path: fit_spec(param_spec(path.split("."), x.ndim, mode=mode,
                                      fsdp=fsdp), tuple(x.shape), mesh)
            for path, x in param_shapes(cfg).items()}


def param_specs(cfg: lm.ArchConfig, mesh: Mesh, mode: str = "fsdp_tp"
                ) -> dict:
    """The tree of specs matching the JAX ``init_params(cfg)`` (nested
    dicts, divisibility-fitted)."""
    from repro_torch import convert

    return convert.nest(_flat_specs(cfg, mesh, mode))


def opt_state_specs(param_sp: PyTree) -> optim.OptState:
    """Optimiser moments mirror the params; step is replicated."""
    return optim.OptState(step=P(), mu=param_sp, nu=param_sp)


def batch_specs(cfg: lm.ArchConfig, mesh: Mesh) -> dict:
    dp = dp_axes(mesh)
    specs = {"inputs": P(dp, None, None) if cfg.input_mode == "embeds"
             else P(dp, None), "labels": P(dp, None)}
    if cfg.rope == "mrope":
        specs["positions"] = P(None, dp, None)
    return specs


def cache_specs(cfg: lm.ArchConfig, mesh: Mesh) -> lm.Cache:
    """Serving-cache shardings: attention KV's sequence axis over "model"
    (a sliding window's small ring stays whole), SSM states' heads over
    "model", the batch over data."""
    dp = dp_axes(mesh)
    k = v = c_kv = k_rope = conv = ssm = None
    if cfg.ssm or cfg.hybrid:
        conv = P(None, dp, None, None)
        ssm = P(None, dp, "model", None, None)
    if cfg.mla:
        c_kv = P(None, dp, "model", None)
        k_rope = P(None, dp, "model", None)
    elif cfg.uses_attention:
        if cfg.sliding_window:
            k = v = P(None, dp, None, None, None)
        else:
            k = v = P(None, dp, "model", None, None)
    return lm.Cache(k=k, v=v, c_kv=c_kv, k_rope=k_rope, conv=conv, ssm=ssm,
                    length=P())


def validate_divisibility(cfg: lm.ArchConfig, mesh: Mesh, mode: str
                          ) -> list[str]:
    """Param axes that do not divide evenly over their mesh axes."""
    msgs = []
    specs = _flat_specs(cfg, mesh, mode)
    for path, x in param_shapes(cfg).items():
        spec = specs[path]
        for dim, axis in zip(x.shape, tuple(spec) + (None,) * x.ndim):
            if axis is None:
                continue
            size = _axis_size(mesh, axis)
            if dim % size:
                msgs.append(f"{path.replace('.', '/')}: dim {dim} % {size} "
                            "!= 0 (padded)")
    return msgs


# ---------------------------------------------------------------------------
# NamedSharding and the sharded tensor
# ---------------------------------------------------------------------------

class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec over a mesh. Coordinates
    stand where JAX names devices (a forced mesh repeats one device)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)
        self._maps: dict[tuple, dict] = {}

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def coords(self) -> list[tuple]:
        """Every mesh coordinate, row-major."""
        return list(np.ndindex(*self.mesh.devices.shape))

    def devices_indices_map(self, shape: tuple) -> dict[tuple, tuple]:
        """Coordinate -> the tuple of slices its block holds; raises where
        an axis does not divide, as JAX does. Kept per shape (callers
        read it, never change it)."""
        shape = tuple(shape)
        if shape not in self._maps:
            self._maps[shape] = self._indices(shape)
        return self._maps[shape]

    def _indices(self, shape: tuple) -> dict[tuple, tuple]:
        entries = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        if len(entries) > len(shape):
            raise ValueError(f"{self.spec} has more entries than {shape}")
        names, sizes = self.mesh.axis_names, self.mesh.devices.shape
        cuts = []  # per tensor axis: None, or (grid axes, block size)
        for dim, axis in zip(shape, entries):
            if axis is None:
                cuts.append(None)
                continue
            axes = [names.index(a) for a in (
                axis if isinstance(axis, tuple) else (axis,))]
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(
                    f"{self!r} cuts axis of size {dim} {n} ways; the "
                    f"tiling should evenly divide the shape {shape}")
            cuts.append((axes, dim // n))
        out = {}
        for c in self.coords():
            idx = []
            for dim, cut in zip(shape, cuts):
                if cut is None:
                    idx.append(slice(0, dim))
                    continue
                k = 0
                for a in cut[0]:  # the first axis major
                    k = k * sizes[a] + c[a]
                idx.append(slice(k * cut[1], (k + 1) * cut[1]))
            out[c] = tuple(idx)
        return out

    def place(self, x: torch.Tensor, path: str | None = None
              ) -> "ShardedTensor":
        """``jax.device_put(x, self)``: each coordinate's block copied to
        its device."""
        x = torch.as_tensor(x)
        blocks = {}
        for c, idx in self.devices_indices_map(tuple(x.shape)).items():
            dev = self.mesh.devices[c]
            blk = torch.empty(_extent(idx), dtype=x.dtype, device=dev)
            if blk.device.type != "meta":  # a meta block holds no values
                blk.copy_(x.detach()[idx])
            blocks[c] = blk
        return ShardedTensor(self, tuple(x.shape), x.dtype, blocks, path)


# --- what crosses between coordinates ---------------------------------------

_COLLECTIVES: list | None = None


@contextlib.contextmanager
def recording_collectives(log: list):
    """Log ``(coordinate, kind, bytes)`` into ``log`` for every transfer
    between coordinates made inside (see the module's docstring)."""
    global _COLLECTIVES
    prev, _COLLECTIVES = _COLLECTIVES, log
    try:
        yield log
    finally:
        _COLLECTIVES = prev


def _reading_coordinate(mesh: Mesh):
    """The grid coordinate of the running data coordinate (its model rank
    0's), or None outside a mesh step's coordinate."""
    shard = context.data_shard()
    return None if shard is None or shard.mesh is not mesh else \
        shard.ranks[0]


def record_collective(kind: str, nbytes: int, coord) -> None:
    """Log ``nbytes`` moved by a ``kind`` collective ("all-gather",
    "all-reduce") for the grid coordinate ``coord`` that receives them."""
    if _COLLECTIVES is not None and nbytes:
        _COLLECTIVES.append((coord, kind, int(nbytes)))


def _extent(idx: tuple) -> tuple:
    return tuple(s.stop - s.start for s in idx)


def _key(idx: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in idx)


def _intersect(a: tuple, b: tuple):
    """The overlap of two slice tuples, or None."""
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _shift(idx: tuple, origin: tuple) -> tuple:
    return tuple(slice(s.start - o.start, s.stop - o.start)
                 for s, o in zip(idx, origin))


class ShardedTensor:
    """A logical tensor stored as blocks over a mesh: ``blocks[coord]`` on
    ``mesh.devices[coord]``, each exactly the slice JAX's placement gives
    that coordinate. Blocks with the same slice are copies; reads take
    each distinct slice from its *owner*, the first coordinate (row-major)
    holding it, so gradients land there (`owners`).

    A *view* (`constrain`) has the same values under another sharding:
    its blocks are cut from its source's on request."""

    def __init__(self, sharding: NamedSharding, shape: tuple, dtype,
                 blocks: dict | None, path: str | None = None,
                 source: "ShardedTensor | None" = None):
        self.sharding, self.shape, self.dtype = sharding, tuple(shape), dtype
        self._blocks, self.path, self.source = blocks, path, source
        self.index = sharding.devices_indices_map(self.shape)

    # -- structure --
    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"ShardedTensor({self.path or ''} {list(self.shape)} "
                f"{self.dtype}, {self.spec!r})")

    @property
    def blocks(self) -> dict:
        """Coordinate -> block (a view computes them)."""
        if self._blocks is None:
            return {c: self.source.read(idx, self.mesh.devices[c])
                    for c, idx in self.index.items()}
        return self._blocks

    def owners(self) -> dict[tuple, tuple]:
        """Coordinate of the first block of each distinct slice."""
        out = {}
        for c, idx in self.index.items():
            out.setdefault(_key(idx), c)
        return {c: self.index[c] for c in out.values()}

    def nbytes(self) -> dict[tuple, int]:
        """Bytes resident at each coordinate (copies counted where they
        live)."""
        item = self.dtype.itemsize
        return {c: math.prod(_extent(idx)) * item
                for c, idx in self.index.items()}

    # -- values --
    def read(self, region: tuple | None = None, device=None) -> torch.Tensor:
        """The logical ``self[region]`` on ``device`` (the first
        coordinate's by default), assembled from the owners' blocks with
        differentiable copies."""
        if self.source is not None:
            return self.source.read(region, device)
        full = tuple(slice(0, n) for n in self.shape)
        region = full if region is None else tuple(region) + full[len(
            tuple(region)):]
        region = tuple(slice(s.start or 0, n if s.stop is None else s.stop)
                       for s, n in zip(region, self.shape))
        device = torch.device(device) if device is not None else \
            self.mesh.devices.flat[0]
        parts, moved = [], 0
        reader = _reading_coordinate(self.mesh)
        for c, idx in self.owners().items():
            hit = _intersect(idx, region)
            if hit is not None:
                parts.append((_shift(hit, region),
                              self._blocks[c][_shift(hit, idx)]))
                if c != reader:
                    moved += math.prod(_extent(hit))
        record_collective("all-gather", moved * self.dtype.itemsize, reader)
        if len(parts) == 1 and _extent(parts[0][0]) == _extent(region):
            return parts[0][1].to(device)
        out = torch.empty(_extent(region), dtype=self.dtype, device=device)
        for at, blk in parts:
            out[at] = blk.to(device)
        return out

    def full(self, device=None) -> torch.Tensor:
        return self.read(None, device)

    def write(self, region: tuple, value: torch.Tensor) -> None:
        """Copy ``value`` into ``self[region]`` in every block it touches,
        copies too (in place: a donated buffer)."""
        full = tuple(slice(0, n) for n in self.shape)
        region = tuple(region) + full[len(tuple(region)):]
        with torch.no_grad():
            for c, idx in self.index.items():
                hit = _intersect(idx, region)
                if hit is not None:
                    blk = self._blocks[c]
                    blk[_shift(hit, idx)] = value[_shift(hit, region)].to(
                        blk.device)

    def sync(self) -> None:
        """Refresh every copy from its owner."""
        owners = {_key(idx): c for c, idx in self.owners().items()}
        with torch.no_grad():
            for c, idx in self.index.items():
                src = owners[_key(idx)]
                if src != c:
                    self._blocks[c].copy_(self._blocks[src])

    @classmethod
    def assemble(cls, spec: P, mesh: Mesh, shape: tuple, dtype,
                 pieces: list) -> "ShardedTensor":
        """A tensor laid out by ``spec`` from pieces ``(region, tensor)``
        of it (the data coordinates' outputs): each block copied from the
        pieces it overlaps."""
        sh = NamedSharding(mesh, spec)
        out = cls(sh, shape, dtype, {})
        for c, idx in out.index.items():
            blk = torch.empty(_extent(idx), dtype=dtype,
                              device=mesh.devices[c])
            for region, x in pieces:
                hit = _intersect(idx, region)
                if hit is not None:
                    blk[_shift(hit, idx)] = x[_shift(hit, region)].to(
                        blk.device)
            out._blocks[c] = blk
        return out

    def constrain(self, spec: P) -> "ShardedTensor":
        """The same values under ``spec`` (a view: ``with_sharding_
        constraint``)."""
        return ShardedTensor(NamedSharding(self.mesh, spec), self.shape,
                             self.dtype, None, self.path,
                             self.source or self)


def to_shardings(specs: PyTree, mesh: Mesh) -> PyTree:
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def place(tree: PyTree, shardings: PyTree) -> PyTree:
    """``jax.device_put(tree, shardings)``: tensors (or numpy, or sharded
    tensors, re-placed) -> `ShardedTensor`s; a None sharding leaves its
    leaf alone."""
    def put(s, x):
        if x is None:
            return None
        if s is None:
            return x
        if isinstance(x, ShardedTensor):
            x = x.full()
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return s.place(x)

    return tree_map(put, shardings, tree,
                    is_leaf=lambda x: isinstance(x, NamedSharding))


# ---------------------------------------------------------------------------
# the LM on a mesh
# ---------------------------------------------------------------------------

def _jax_path(name: str) -> str:
    """``layers.3.attn.q.w`` -> ``layers.attn.q.w``."""
    head, _, rest = name.partition(".")
    if head == "layers":
        return "layers." + rest.partition(".")[2]
    return name


def leaf_spec(specs: dict, name: str) -> P:
    """A port tensor's spec in the JAX tree ``specs``: a per-layer
    tensor's without its leading None."""
    node = specs
    for part in _jax_path(name).split("."):
        node = node[part]
    return node[1:] if name.startswith("layers.") else node


def _owner(root: torch.nn.Module, name: str):
    mod, _, leaf = name.rpartition(".")
    return (root.get_submodule(mod) if mod else root), leaf


def shard_module(module: torch.nn.Module, specs: dict, mesh: Mesh,
                 prefix: str = "") -> torch.nn.Module:
    """``module`` stored on the mesh: the same module tree with each
    parameter a `ShardedTensor` placed by its spec (``specs`` a
    `param_specs` tree), named ``prefix`` + its name in ``module`` (a
    layer of the model: ``"layers.0."``)."""
    out = _copy_tree(module)
    for name, p in list(module.named_parameters()):
        mod, leaf = _owner(out, name)
        del mod._parameters[leaf]
        path = prefix + name
        st = NamedSharding(mesh, leaf_spec(specs, path)).place(p.data, path)
        object.__setattr__(mod, leaf, st)
    return out


def shard_model(model: lm.LM, specs: dict, mesh: Mesh) -> lm.LM:
    """The model stored on the mesh (`shard_module`). Each MoE module
    learns its layer index (its routing statistics are taken over the
    global batch)."""
    out = shard_module(model, specs, mesh)
    for i, layer in enumerate(out.layers):
        if getattr(layer, "moe", None) is not None:
            layer.moe.layer = i
    return out


def _copy_tree(m: torch.nn.Module) -> torch.nn.Module:
    """A copy of the module tree sharing the leaves."""
    new = copy.copy(m)
    new.__dict__ = dict(m.__dict__)
    new._parameters = dict(m._parameters)
    new._buffers = dict(m._buffers)
    new._modules = {k: None if c is None else _copy_tree(c)
                    for k, c in m._modules.items()}
    return new


def sharded_tensors(model: lm.LM) -> dict[str, ShardedTensor]:
    """A sharded model's tensors by the port's parameter names, in the
    unsharded model's `named_parameters` order."""
    out = {}
    for mod_name, mod in model.named_modules():
        for k, v in mod.__dict__.items():
            if isinstance(v, ShardedTensor):
                out[f"{mod_name}.{k}" if mod_name else k] = v
    return out


def map_leaves(tree, fn):
    """``tree`` (a module tree, a `lm.Head` or a tensor) with each
    `ShardedTensor` leaf replaced by ``fn(leaf)``: new module objects, the
    other leaves shared."""
    if isinstance(tree, ShardedTensor):
        return fn(tree)
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(v, fn) for v in tree))
    new = copy.copy(tree)
    new.__dict__ = {k: fn(v) if isinstance(v, ShardedTensor) else v
                    for k, v in tree.__dict__.items()}
    new._modules = {k: None if c is None else map_leaves(c, fn)
                    for k, c in tree._modules.items()}
    return new


def placer(device) -> callable:
    """A data coordinate's placement: every sharded leaf whole on
    ``device`` (differentiable)."""
    return lambda tree: map_leaves(tree, lambda st: st.full(device))


def register_zero3_constraints(cfg: lm.ArchConfig, mesh: Mesh, mode: str
                               ) -> None:
    """Install gather-at-use constraints (`context.constrain_layer`).

    Storage is `mode` (fsdp_tp shards a weight axis over dp); compute is
    the "tp" rule set. Constraining each layer's parameters to the compute
    sharding at layer entry gathers exactly one layer's weights at a time
    (ZeRO-3 streaming); the gradients go back through the same gather."""
    if mode != "fsdp_tp":
        context.set_layer_constraint(None)
        context.set_head_constraint(None)
        return
    compute = _flat_specs(cfg, mesh, "tp")

    def to_compute(st: ShardedTensor) -> ShardedTensor:
        spec = compute[_jax_path(st.path)]
        return st.constrain(spec[1:] if st.path.startswith("layers.")
                            else spec)

    context.set_layer_constraint(lambda p: map_leaves(p, to_compute))
    context.set_head_constraint(lambda p: map_leaves(p, to_compute))


# ---------------------------------------------------------------------------
# the JAX tree of a sharded model (checkpoints, comparisons)
# ---------------------------------------------------------------------------

def stack(parts: list[ShardedTensor], path: str, mesh: Mesh
          ) -> ShardedTensor:
    """Per-layer sharded tensors -> the stacked leaf (axis 0 unsharded),
    block by block."""
    spec = P(None, *parts[0].spec)
    sh = NamedSharding(mesh, spec)
    blocks = {c: torch.stack([p.blocks[c] for p in parts])
              for c in parts[0].index}
    return ShardedTensor(sh, (len(parts), *parts[0].shape), parts[0].dtype,
                         blocks, path)


def unstack(st: ShardedTensor, name_of) -> list[ShardedTensor]:
    """The inverse of `stack`: ``name_of(i)`` names layer i's tensor."""
    sh = NamedSharding(st.mesh, st.spec[1:])
    return [ShardedTensor(sh, st.shape[1:], st.dtype,
                          {c: b[i].clone() for c, b in st.blocks.items()},
                          name_of(i))
            for i in range(st.shape[0])]


def model_tree(tensors: dict[str, ShardedTensor], mesh: Mesh) -> dict:
    """Sharded tensors by port name -> the JAX tree of sharded leaves,
    layers stacked (`convert.lm_tree` for a mesh)."""
    from repro_torch import convert

    flat, per = {}, {}
    for name, st in tensors.items():
        path = _jax_path(name)
        if name.startswith("layers."):
            per.setdefault(path, []).append(st)
        else:
            flat[path] = st
    for path, parts in per.items():
        flat[path] = stack(parts, path, mesh)
    return convert.nest(flat)


def untree(tree: dict) -> dict[str, ShardedTensor]:
    """The inverse of `model_tree`: port name -> sharded tensor."""
    from repro_torch import convert

    out = {}
    for path, st in convert.flatten_tree(tree).items():
        head, _, leaf = path.partition(".")
        if head == "layers":
            for i, part in enumerate(unstack(
                    st, lambda i, leaf=leaf: f"layers.{i}.{leaf}")):
                out[part.path] = part
        else:
            st.path = path
            out[path] = st
    return out


def load_tensors(model: lm.LM, tensors: dict[str, ShardedTensor]) -> None:
    """Set a sharded model's tensors (restored, or re-placed) by name."""
    for name, st in tensors.items():
        mod, leaf = _owner(model, name)
        object.__setattr__(mod, leaf, st)
