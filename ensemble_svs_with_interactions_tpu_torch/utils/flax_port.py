"""Carry weights between the JAX package's flax variables and the port's
modules, both ways.

The port's submodules carry the flax scope names, so a torch module path
(``LSTM_0.l0_fwd``) is the flax path (``LSTM_0/l0_fwd``).  Each leaf
module converts its flax subtree to torch layouts:

* ``nn.Linear``    <- Dense ``kernel (in, out)`` (transposed) and ``bias``
  (among them the AR decoder's ``prenet/fc{i}`` and its MDN heads
  ``log_pi``, ``log_sigma``, ``mu``);
* ``nn.Conv1d``, ``nn.Conv2d`` and the vocoder discriminators'
  ``SameConv`` <- Conv ``kernel (*k, Cin/groups, Cout)`` as (Cout,
  Cin/groups, *k) and ``bias`` where the conv has one, which covers the
  depthwise ``conv_downsample`` (``feature_group_count = C``), the
  dilated convolutions (the dilation is the module's, not the kernel's),
  the vocoders' bias-free aux and upsampling convolutions and the
  postfilters' NHWC images (NCHW here); a weight-normed ``SameConv``'s
  ``scale`` <- flax ``nn.WeightNorm``'s, which lives beside the conv at
  ``WeightNorm_{k}`` under the key ``Conv_{k}/kernel/scale`` (one key
  holding slashes) for the conv ``Conv_{k}``;
* ``nn.Embedding`` <- Embed ``embedding``;
* ``nn.LayerNorm`` <- ``scale``, ``bias``;
* ``MaskedBatchNorm`` <- ``scale``, ``bias`` and the ``batch_stats``
  running ``mean`` / ``var``;
* LSTM weights (``_MaskedLSTMLayer`` holds its cell under
  ``OptimizedLSTMCell_0``, the AR decoder's ``LSTMCell`` is the cell):
  flax ``OptimizedLSTMCell`` keeps per-gate Dense kernels, ``i{i,f,g,o}``
  on the input path and ``h{i,f,g,o}`` on the recurrent path, which also
  carries the bias; they concatenate, in gate order i, f, g, o, into
  ``w_x (C, 4H)``, ``w_h (H, 4H)`` and ``b (4H,)``;
* a module's own parameters named in its ``FLAX_LEAVES`` (the FFT
  encoder's ``pos_embed_alpha``, the FIR filters' ``taps``, the relative
  attention's ``emb_rel_k`` / ``emb_rel_v``) <- the flax leaf of the
  same name.

Every flax leaf must be consumed and every torch parameter and buffer set,
or ``flax_to_torch`` raises.  ``torch_to_flax`` is its inverse: it splits
the LSTM weights back into the per-gate Dense kernels (the bias on the h
path), transposes the Dense and Conv kernels back and rebuilds
``batch_stats``; it raises on any torch tensor it cannot place, and
``flax_to_torch(m2, torch_to_flax(m1))`` reproduces every tensor of ``m1``
bitwise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    MaskedBatchNorm,
    _MaskedLSTMLayer,
)
from ensemble_svs_with_interactions_tpu_torch.models.tacotron import LSTMCell
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.discriminators import (  # noqa: E501
    SameConv,
)

_GATES = ("i", "f", "g", "o")
# convolutions: flax kernel (*k, Cin/groups, Cout), torch (Cout, Cin/groups,
# *k)
_CONVS = (nn.Conv1d, nn.Conv2d, SameConv)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lstm_arrays(cell: Dict):
    w_x = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATES],
                         axis=1)
    w_h = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in _GATES],
                         axis=1)
    b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
    return w_x, w_h, b


def _weight_norm_scope(name: str):
    """(scope, key) of flax's ``nn.WeightNorm`` scale of the conv scope
    ``name`` (``Conv_{k}``): the sibling ``WeightNorm_{k}``."""
    return f"WeightNorm_{name.split('_')[-1]}", f"{name}/kernel/scale"


def _convert(module, p, s):
    """(torch name -> tensor) for one leaf module from its flax params ``p``
    and batch stats ``s``, plus the flax leaves used (relative paths)."""
    if isinstance(module, (nn.Linear, *_CONVS)):
        kernel = _t(p["kernel"])
        if isinstance(module, nn.Linear):
            out = {"weight": kernel.t()}
        else:
            nd = len(module.kernel_size)
            out = {"weight": kernel.permute(nd + 1, nd, *range(nd))}
        used = ["kernel"]
        if module.bias is not None:
            out["bias"] = _t(p["bias"])
            used.append("bias")
        return out, used, []
    if isinstance(module, nn.Embedding):
        return {"weight": _t(p["embedding"])}, ["embedding"], []
    if isinstance(module, nn.LayerNorm):
        return ({"weight": _t(p["scale"]), "bias": _t(p["bias"])},
                ["scale", "bias"], [])
    if isinstance(module, MaskedBatchNorm):
        return ({"weight": _t(p["scale"]), "bias": _t(p["bias"]),
                 "running_mean": _t(s["mean"]), "running_var": _t(s["var"])},
                ["scale", "bias"], ["mean", "var"])
    if isinstance(module, (_MaskedLSTMLayer, LSTMCell)):
        prefix = "OptimizedLSTMCell_0/" if isinstance(
            module, _MaskedLSTMLayer) else ""
        cell = p["OptimizedLSTMCell_0"] if prefix else p
        w_x, w_h, b = _lstm_arrays(cell)
        used = ([f"{prefix}i{g}/kernel" for g in _GATES]
                + [f"{prefix}h{g}/{k}" for g in _GATES
                   for k in ("kernel", "bias")])
        return {"w_x": _t(w_x), "w_h": _t(w_h), "b": _t(b)}, used, []
    leaves = [k for k in _flax_leaves(module) if k in p]
    if leaves:
        return {k: _t(p[k]) for k in leaves}, leaves, []
    return None


def _flax_leaves(module):
    """The module's own parameters that flax keeps as leaves of the same
    name (``FLAX_LEAVES``, those that exist)."""
    return [k for k in getattr(module, "FLAX_LEAVES", ())
            if getattr(module, k, None) is not None]


def _subtree(tree: Dict, path):
    node = tree
    for part in path:
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _leaves(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _leaves(v, f"{prefix}{k}/")
        else:
            out.add(f"{prefix}{k}")
    return out


def _plain(tree):
    """Nested mapping (flax FrozenDict or dict) -> nested dict."""
    return {k: _plain(v) if hasattr(v, "items") else v for k, v in tree.items()}


@torch.no_grad()
def flax_to_torch(module: nn.Module, variables) -> nn.Module:
    """Copy flax ``variables`` (``{"params": ..., "batch_stats": ...}``,
    nested dicts of arrays) into ``module`` in place; returns it."""
    params = _plain(variables.get("params", {}))
    stats = _plain(variables.get("batch_stats", {}))
    used_p, used_s, assigned = set(), set(), set()
    for name, sub in module.named_modules():
        path = name.split(".") if name else []
        p = _subtree(params, path)
        if p is None:
            continue
        conv = _convert(sub, p, _subtree(stats, path) or {})
        if conv is None:
            continue
        tensors, leaves_p, leaves_s = conv
        prefix = "/".join(path) + "/" if path else ""
        if isinstance(sub, SameConv) and sub.scale is not None:
            scope, key = _weight_norm_scope(path[-1])
            tensors["scale"] = _t(_subtree(params, path[:-1] + [scope])[key])
            used_p.add("/".join(path[:-1] + [scope, key]))
        used_p |= {prefix + leaf for leaf in leaves_p}
        used_s |= {prefix + leaf for leaf in leaves_s}
        own = dict(sub.named_parameters(recurse=False))
        own.update(sub.named_buffers(recurse=False))
        for key, value in tensors.items():
            if tuple(own[key].shape) != tuple(value.shape):
                raise ValueError(
                    f"{name}.{key}: torch {tuple(own[key].shape)} vs flax "
                    f"{tuple(value.shape)}")
            own[key].copy_(value)
            assigned.add(f"{name}.{key}" if name else key)
    missing_p = _leaves(params) - used_p
    missing_s = _leaves(stats) - used_s
    unset = {n for n, _ in module.named_parameters()} - assigned
    unset |= {n for n, _ in module.named_buffers()} - assigned
    if missing_p or missing_s or unset:
        raise ValueError(
            "flax_to_torch: unmatched weights; flax params not consumed: "
            f"{sorted(missing_p)}, flax batch_stats not consumed: "
            f"{sorted(missing_s)}, torch tensors not set: {sorted(unset)}")
    return module


def _n(t: torch.Tensor) -> np.ndarray:
    """A contiguous copy, never a view of a live CPU parameter."""
    return t.detach().cpu().numpy().copy()


def _to_flax(module):
    """(flax params, flax batch stats, torch names used) of one leaf module,
    the flax trees keyed by paths relative to the module; None for a
    module that holds no weights of its own."""
    if isinstance(module, (nn.Linear, *_CONVS)):
        w = module.weight
        if isinstance(module, nn.Linear):
            p = {"kernel": _n(w.t())}
        else:
            p = {"kernel": _n(w.permute(*range(2, w.dim()), 1, 0))}
        used = ["weight"]
        if module.bias is not None:
            p["bias"] = _n(module.bias)
            used.append("bias")
        return p, {}, used
    if isinstance(module, nn.Embedding):
        return {"embedding": _n(module.weight)}, {}, ["weight"]
    if isinstance(module, nn.LayerNorm):
        return ({"scale": _n(module.weight), "bias": _n(module.bias)}, {},
                ["weight", "bias"])
    if isinstance(module, MaskedBatchNorm):
        return ({"scale": _n(module.weight), "bias": _n(module.bias)},
                {"mean": _n(module.running_mean),
                 "var": _n(module.running_var)},
                ["weight", "bias", "running_mean", "running_var"])
    if isinstance(module, (_MaskedLSTMLayer, LSTMCell)):
        w_x, w_h, b = (np.split(_n(t), 4, axis=-1)
                       for t in (module.w_x, module.w_h, module.b))
        cell = {}
        for k, g in enumerate(_GATES):
            cell[f"i{g}"] = {"kernel": np.ascontiguousarray(w_x[k])}
        for k, g in enumerate(_GATES):
            cell[f"h{g}"] = {"kernel": np.ascontiguousarray(w_h[k]),
                             "bias": np.ascontiguousarray(b[k])}
        if isinstance(module, _MaskedLSTMLayer):
            cell = {"OptimizedLSTMCell_0": cell}
        return cell, {}, ["w_x", "w_h", "b"]
    leaves = _flax_leaves(module)
    if leaves:
        return {k: _n(getattr(module, k)) for k in leaves}, {}, leaves
    return None


def _put(tree: Dict, path, leaves: Dict):
    if not leaves:
        return
    node = tree
    for part in path:
        node = node.setdefault(part, {})
    node.update(leaves)


@torch.no_grad()
def torch_to_flax(module: nn.Module) -> Dict:
    """The flax variables (``{"params": ..., "batch_stats": ...}``, nested
    dicts of float32 numpy arrays; ``batch_stats`` only where the module
    has batch norms) of the port's ``module``: the inverse of
    ``flax_to_torch``."""
    params, stats, placed = {}, {}, set()
    for name, sub in module.named_modules():
        conv = _to_flax(sub)
        if conv is None:
            continue
        p, s, used = conv
        path = name.split(".") if name else []
        _put(params, path, p)
        _put(stats, path, s)
        placed |= {f"{name}.{k}" if name else k for k in used}
        if isinstance(sub, SameConv) and sub.scale is not None:
            scope, key = _weight_norm_scope(path[-1])
            _put(params, path[:-1] + [scope], {key: _n(sub.scale)})
            placed.add(f"{name}.scale")
    every = {n for n, _ in module.named_parameters()}
    every |= {n for n, _ in module.named_buffers()}
    if every - placed:
        raise ValueError("torch_to_flax: torch tensors with no flax place: "
                         f"{sorted(every - placed)}")
    return {"params": params, **({"batch_stats": stats} if stats else {})}
