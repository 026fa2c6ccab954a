"""Load the JAX package's flax variables into the port's modules.

The port's submodules carry the flax scope names, so a torch module path
(``LSTM_0.l0_fwd``) is the flax path (``LSTM_0/l0_fwd``).  Each leaf
module converts its flax subtree to torch layouts:

* ``nn.Linear``    <- Dense ``kernel (in, out)`` (transposed) and ``bias``;
* ``nn.Conv1d``    <- Conv ``kernel (K, Cin/groups, Cout)`` as
  (Cout, Cin/groups, K), which covers the depthwise ``conv_downsample``
  (``feature_group_count = C``);
* ``nn.Embedding`` <- Embed ``embedding``;
* ``nn.LayerNorm`` <- ``scale``, ``bias``;
* ``MaskedBatchNorm`` <- ``scale``, ``bias`` and the ``batch_stats``
  running ``mean`` / ``var``;
* LSTM weights (``_MaskedLSTMLayer`` holds its cell under
  ``OptimizedLSTMCell_0``, the AR decoder's ``LSTMCell`` is the cell):
  flax ``OptimizedLSTMCell`` keeps per-gate Dense kernels, ``i{i,f,g,o}``
  on the input path and ``h{i,f,g,o}`` on the recurrent path, which also
  carries the bias; they concatenate, in gate order i, f, g, o, into
  ``w_x (C, 4H)``, ``w_h (H, 4H)`` and ``b (4H,)``.

Every flax leaf must be consumed and every torch parameter and buffer set,
or ``flax_to_torch`` raises.
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

_GATES = ("i", "f", "g", "o")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lstm_arrays(cell: Dict):
    w_x = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATES],
                         axis=1)
    w_h = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in _GATES],
                         axis=1)
    b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
    return w_x, w_h, b


def _convert(module, p, s):
    """(torch name -> tensor) for one leaf module from its flax params ``p``
    and batch stats ``s``, plus the flax leaves used (relative paths)."""
    if isinstance(module, nn.Linear):
        out = {"weight": _t(p["kernel"]).t()}
        used = ["kernel"]
        if module.bias is not None:
            out["bias"] = _t(p["bias"])
            used.append("bias")
        return out, used, []
    if isinstance(module, nn.Conv1d):
        return ({"weight": _t(p["kernel"]).permute(2, 1, 0),
                 "bias": _t(p["bias"])}, ["kernel", "bias"], [])
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
    return None


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
    params = _plain(variables["params"])
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
