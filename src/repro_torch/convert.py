"""Carry weights, prune masks and template banks between the JAX package
and the port.

Inputs and outputs are plain numpy (``np.asarray`` of each JAX leaf), so
this module imports neither JAX nor `repro`. The JAX pytrees nest dicts
named like the port's modules: a conv or dense ``{"w", "b"}`` (HWIO / (in,
out)) is a ``Conv2d`` / ``Linear`` (OIHW / (out, in)); a BatchNorm
``{"scale", "bias", "mean", "var"}`` is a ``BatchNorm2d``'s weight, bias
and running statistics. The LM keeps the JAX names and layouts
(`repro_torch.models.lm`), its layers stacked on axis 0 in the JAX tree;
`lm_tree` / `lm_untree` carry its parameters and AdamW moments both ways
(tensor leaves), so a checkpoint in the JAX on-disk format means the same
thing to both packages' launchers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.templates import TemplateBank
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.cnn import (Student, StudentConfig, Teacher,
                                    TeacherConfig)
from repro_torch.optim import optimizers as optim

# JAX leaf name -> the port's, for dense/conv and BatchNorm dicts
_DENSE = {"w": "weight", "b": "bias"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def student_from_numpy(params: dict, *, device=None) -> Student:
    """The JAX student pytree (numpy leaves) -> the port's `Student`:
    conv ``w`` HWIO -> OIHW, ``bn*`` scale/bias/mean/var -> BatchNorm
    weight/bias/running_mean/running_var, ``head`` (F, C) -> Linear (C, F)."""
    filters = tuple(int(np.shape(params[f"conv{i}"]["w"])[3])
                    for i in range(1, 5))
    head_w = np.asarray(params["head"]["w"])
    cfg = StudentConfig(in_channels=int(np.shape(params["conv1"]["w"])[2]),
                        filters=filters, num_classes=int(head_w.shape[1]))
    if head_w.shape[0] != cfg.num_features:
        raise ValueError(f"head expects {head_w.shape[0]} features, the "
                         f"convs give {cfg.num_features}")
    model = Student(cfg)
    with torch.no_grad():
        for i in range(1, 5):
            conv = getattr(model, f"conv{i}")
            conv.weight.copy_(_t(np.transpose(params[f"conv{i}"]["w"],
                                              (3, 2, 0, 1))))
            conv.bias.copy_(_t(params[f"conv{i}"]["b"]))
        for i in (1, 2):
            bn, p = getattr(model, f"bn{i}"), params[f"bn{i}"]
            bn.weight.copy_(_t(p["scale"]))
            bn.bias.copy_(_t(p["bias"]))
            bn.running_mean.copy_(_t(p["mean"]))
            bn.running_var.copy_(_t(p["var"]))
        model.head.weight.copy_(_t(head_w.T))
        model.head.bias.copy_(_t(params["head"]["b"]))
    return model.to(resolve(device)).eval()


def _to_port_layout(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w)
    return np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A JAX params (or masks) pytree -> the port's ``state_dict`` names,
    leaves in the port's layouts."""
    flat = {}
    for key, sub in tree.items():
        if "w" in sub:
            flat[f"{prefix}{key}.weight"] = _to_port_layout(sub["w"])
            flat[f"{prefix}{key}.bias"] = np.asarray(sub["b"])
        elif "scale" in sub:
            for leaf, name in _BN.items():
                flat[f"{prefix}{key}.{name}"] = np.asarray(sub[leaf])
        else:
            flat.update(_flatten(sub, f"{prefix}{key}."))
    return flat


def teacher_from_numpy(params: dict, *, device=None) -> Teacher:
    """The JAX teacher pytree (numpy leaves) -> the port's `Teacher`, its
    config read off the shapes."""
    stem = np.shape(params["stem"]["w"])
    cfg = TeacherConfig(
        in_channels=int(stem[2]), width=int(stem[3]),
        blocks_per_stage=sum(k.startswith("s0b") for k in params),
        num_classes=int(np.shape(params["head"]["w"])[1]))
    model = Teacher(cfg)
    state = {k: _t(v) for k, v in _flatten(params).items()}
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise ValueError(f"teacher params do not match {cfg}: missing "
                         f"{missing}, unexpected {unexpected}")
    return model.to(resolve(device)).eval()


def to_numpy(model: Student | Teacher) -> dict:
    """The port's student or teacher -> the JAX package's params pytree
    (numpy leaves, JAX layouts), e.g. to compare parameters after a step."""
    tree: dict = {}
    for name, x in model.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        node = tree
        for key in path.split("."):
            node = node.setdefault(key, {})
        x = x.detach().cpu().numpy()
        if isinstance(model.get_submodule(path), torch.nn.BatchNorm2d):
            node[{v: k for k, v in _BN.items()}[leaf]] = x
        else:
            if leaf == "weight":
                x = np.transpose(x, (2, 3, 1, 0)) if x.ndim == 4 else x.T
            node[{v: k for k, v in _DENSE.items()}[leaf]] = x
    return tree


def masks_from_numpy(masks: dict, model: Student | Teacher
                     ) -> dict[str, torch.Tensor]:
    """A JAX prune-mask pytree -> the port's masks: bool tensors keyed by
    parameter name, on the model's device (the masks of BatchNorm running
    statistics, which are buffers here, are dropped)."""
    flat = _flatten(masks)
    return {name: torch.from_numpy(np.array(flat[name], dtype=bool)).to(
        p.device) for name, p in model.named_parameters()}


def bank_from_numpy(templates, lower, upper, valid, thresholds, *,
                    device=None) -> TemplateBank:
    """The five `TemplateBank` arrays (numpy) -> a port bank on a device."""
    dev = resolve(device)
    return TemplateBank(
        templates=_t(templates).to(dev), lower=_t(lower).to(dev),
        upper=_t(upper).to(dev),
        valid=torch.from_numpy(np.array(valid, dtype=bool)).to(dev),
        thresholds=_t(thresholds).to(dev))


def _tensor(x) -> torch.Tensor:
    """A numpy leaf -> a tensor of its own dtype. A bfloat16 leaf (an
    ``ml_dtypes`` array, which `torch.from_numpy` rejects) travels as its
    raw 16-bit patterns."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def lm_params_from_numpy(params: dict, cfg: lm.ArchConfig, *,
                         device=None) -> lm.LM:
    """The JAX LM pytree (numpy leaves, layers stacked on axis 0) -> the
    port's `lm.LM` on ``device``, every leaf in its own dtype: attention
    or MLA, the MLP or the MoE (``router.w`` f32, the expert stacks, the
    shared expert), the SSD block and hymba's output norms."""
    dev = resolve(device)

    def tensor(x):
        return _tensor(x).to(dev)

    def linear(p, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        b = p.get("b")
        return L.Linear(tensor(pick(p["w"])),
                        None if b is None else tensor(pick(b)))

    def norm(p, i=None):
        n = L.RMSNorm(1, device=dev)
        n.scale = torch.nn.Parameter(
            tensor(p["scale"] if i is None else p["scale"][i]),
            requires_grad=False)
        return n

    def mlp(m, i):
        return L.MLP(linear(m["gate"], i), linear(m["up"], i),
                     linear(m["down"], i))

    def attn(a, i):
        if cfg.mla:
            return lm.MLA(linear(a["q_a"], i), norm(a["q_a_norm"], i),
                          linear(a["q_b"], i), linear(a["kv_a"], i),
                          norm(a["kv_a_norm"], i), linear(a["kv_b"], i),
                          linear(a["o"], i))
        return lm.Attention(
            linear(a["q"], i), linear(a["k"], i), linear(a["v"], i),
            linear(a["o"], i),
            norm(a["q_norm"], i) if cfg.qk_norm else None,
            norm(a["k_norm"], i) if cfg.qk_norm else None)

    def ssd(s, i):
        return L.SSD(linear(s["in_proj"], i), tensor(s["conv_w"][i]),
                     tensor(s["A_log"][i]), tensor(s["D"][i]),
                     tensor(s["dt_bias"][i]), norm(s["out_norm"], i),
                     linear(s["out_proj"], i))

    def moe(m, i):
        return L.MoE(linear(m["router"], i), tensor(m["gate"][i]),
                     tensor(m["up"][i]), tensor(m["down"][i]),
                     mlp(m["shared"], i) if "shared" in m else None)

    st = params["layers"]
    layers = []
    for i in range(cfg.n_layers):
        ln1 = norm(st["ln1"], i)
        if cfg.ssm:
            layers.append(lm.Layer(ln1, None, None, None,
                                   ssd=ssd(st["ssd"], i)))
            continue
        extra = {}
        if cfg.hybrid:
            extra = dict(ssd=ssd(st["ssd"], i),
                         attn_out_norm=norm(st["attn_out_norm"], i),
                         ssm_out_norm=norm(st["ssm_out_norm"], i))
        if "moe" in st:
            extra["moe"] = moe(st["moe"], i)
        layers.append(lm.Layer(
            ln1, attn(st["attn"], i), norm(st["ln2"], i),
            mlp(st["mlp"], i) if "mlp" in st else None, **extra))
    embed = tensor(params["embed"]) if "embed" in params else None
    return lm.LM(embed, linear(params["unembed"]),
                 norm(params["final_norm"]), layers).eval()


# ---------------------------------------------------------------------------
# the LM's parameters (and AdamW moments) as the JAX pytree
# ---------------------------------------------------------------------------

def lm_stack(named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Tensors keyed by the port's parameter names (``layers.3.attn.q.w``)
    -> the JAX leaves keyed by their paths joined with dots
    (``layers.attn.q.w``): each per-layer leaf stacked over the layers on
    axis 0, as the JAX package stacks its layer tree."""
    out, per_layer = {}, {}
    for name, x in named.items():
        head, _, rest = name.partition(".")
        if head == "layers":
            i, _, leaf = rest.partition(".")
            per_layer.setdefault(f"layers.{leaf}", {})[int(i)] = x
        else:
            out[name] = x
    for path, by_layer in per_layer.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{path}: layers {sorted(by_layer)}")
        out[path] = torch.stack([by_layer[i] for i in range(len(by_layer))])
    return out


def lm_unstack(stacked: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of `lm_stack`: each stacked leaf split back into its
    layers' tensors under the port's parameter names."""
    out = {}
    for path, x in stacked.items():
        head, _, leaf = path.partition(".")
        if head == "layers":
            for i in range(x.shape[0]):
                out[f"layers.{i}.{leaf}"] = x[i]
        else:
            out[path] = x
    return out


def nest(flat: dict) -> dict:
    """Dotted paths -> the nested dicts of a JAX pytree."""
    tree: dict = {}
    for path, x in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = x
    return tree


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """The inverse of `nest`: nested dicts -> dotted paths."""
    flat = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            flat.update(flatten_tree(sub, f"{prefix}{key}."))
        else:
            flat[f"{prefix}{key}"] = sub
    return flat


def lm_tree(named: dict[str, torch.Tensor]) -> dict:
    """Tensors keyed by the port's parameter names (the model's, or an
    AdamW moment's) -> the JAX pytree of tensors, layers stacked on axis
    0: what the JAX launcher checkpoints."""
    return nest(lm_stack(named))


def lm_untree(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of `lm_tree`: a JAX LM pytree (tensor leaves) -> tensors
    keyed by the port's parameter names."""
    return lm_unstack(flatten_tree(tree))


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy in its own dtype; bfloat16 as ``ml_dtypes``'
    bfloat16 (numpy has none of its own)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes

        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def lm_params_to_numpy(params: lm.LM, cfg: lm.ArchConfig) -> dict:
    """The inverse of `lm_params_from_numpy`: the port's `lm.LM` -> the
    JAX pytree with numpy leaves, every leaf in its own dtype and the
    layers stacked on axis 0."""
    stacked = lm_stack({k: p.detach() for k, p in params.named_parameters()})
    return nest({k: _numpy(x) for k, x in stacked.items()})


def lm_opt_state_tree(state: optim.OptState) -> optim.OptState:
    """An AdamW (or SGD) state over the port's parameter names -> the JAX
    one: ``mu`` / ``nu`` as `lm_tree`s, ``step`` as it is."""
    return optim.OptState(state.step, lm_tree(state.mu),
                          None if state.nu is None else lm_tree(state.nu))


def lm_opt_state_untree(state: optim.OptState) -> optim.OptState:
    """The inverse of `lm_opt_state_tree`."""
    return optim.OptState(state.step, lm_untree(state.mu),
                          None if state.nu is None else lm_untree(state.nu))
