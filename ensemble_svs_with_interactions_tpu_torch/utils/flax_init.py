"""Initial weights drawn by the flax schemes.

The JAX trainers initialise every model with ``module.init`` (flax's
initializers); torch's defaults are another distribution (uniform
+-1/sqrt(fan_in), non-zero biases).  :func:`init_module` gives a port
module the flax twin's distribution: it takes the module's flax-layout
variables (``flax_port.torch_to_flax``), draws each leaf by the scheme flax
uses at the same scope path, from one ``torch.Generator``, and writes the
draws back (``flax_port.flax_to_torch``).  The schemes:

* ``bias`` zeros, ``scale`` ones (a LayerNorm's, and ``nn.WeightNorm``'s
  ``Conv_{k}/kernel/scale``), batch statistics ``mean`` zeros and ``var``
  ones;
* the hn-uSFGAN ``PeriodicityEstimator``'s last conv kernel
  ``normal(1e-4)``, so its gates start near one half;
* LSTM cells (``OptimizedLSTMCell``): the input kernels ``i{i,f,g,o}``
  ``lecun_normal``, the recurrent kernels ``h{i,f,g,o}`` ``orthogonal``;
* ``embedding``: ``normal(std)`` in a ``SpeakerEmbedding``, else flax's
  ``Embed`` default, ``variance_scaling(1, fan_in, normal, out_axis=0)``;
* Dense and Conv ``kernel``: the model's ``init_type`` choice
  (``models/layers.py`` ``kernel_initializer``: ``none`` lecun_normal,
  ``normal`` normal(0.02), ``xavier_normal`` glorot_normal,
  ``kaiming_normal`` he_normal, ``orthogonal`` orthogonal(0.02)) for the
  layers the JAX model builds with ``kernel_init=init``
  (``INIT_TYPE_LAYERS``), else ``lecun_normal``.

The draws match flax's distributions, not its values (JAX's PRNG is
another generator): the same ``seed`` gives the same weights on every
device and run.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)

# model class -> children whose kernels the JAX model builds with
# ``kernel_init=kernel_initializer(self.init_type)``
INIT_TYPE_LAYERS = {
    "FFConvLSTM": r"Dense_\d+",
    "_SinsyEncoder": r"Dense_\d+",
    "VariancePredictor": r"(Conv|Dense)_\d+",
    "MultiTrackVariancePredictor": r"(Conv|Dense)_\d+",
    "LSTMEncoder": r"Dense_0",
    "MultiTrackLSTMEncoder": r"Dense_0",
    "MDN": r"Dense_\d+",
    "MDNv2": r"Dense_\d+",
    "ResSkipF0FFConvLSTM": r"Dense_\d+",
    # a ReflectConv1d carries its owner's init_type ("none" by default)
    "ReflectConv1d": r"Conv_0",
    "Conv2dD": r"Conv_\d+",
    "Conv2dPostFilter": r"conv\d|fc",
    "_PadConv2dPostFilter": r"conv\d|fc",
}
# jax.nn.initializers' truncation constant: the std of a unit normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
_GAIN = 0.02  # kernel_initializer's init_gain
_GATE_STD = 1e-4  # PeriodicityEstimator's last kernel_init


def _fans(shape) -> Tuple[float, float]:
    """(fan_in, fan_out) of a flax kernel: in axis -2, out axis -1, the
    rest receptive field."""
    rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * rf, shape[-1] * rf


def _truncated_normal(shape, std, gen):
    """Normal of std ``std`` truncated at 2 of its own std before
    rescaling, as ``variance_scaling``'s truncated normal: inverse CDF of a
    uniform draw."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
    return (z * std / _TRUNC_STD).float()


def _normal(shape, std, gen):
    return torch.randn(shape, generator=gen, dtype=torch.float64).mul(
        std).float()


def _variance_scaling(shape, scale, mode, gen, truncated=True, fans=None):
    fan_in, fan_out = fans or _fans(shape)
    denom = {"fan_in": fan_in, "fan_out": fan_out,
             "fan_avg": (fan_in + fan_out) / 2}[mode]
    std = math.sqrt(scale / max(1.0, denom))
    if truncated:
        return _truncated_normal(shape, std, gen)
    return _normal(shape, std, gen)


def _orthogonal(shape, scale, gen):
    """Orthogonal rows or columns over the last axis, as
    ``jax.nn.initializers.orthogonal``: the Q of a normal matrix's QR with
    the signs of R's diagonal."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                    generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return (scale * q).reshape(shape).float()


def _kernel(init_type, shape, gen):
    if init_type in ("none", None):
        return _variance_scaling(shape, 1.0, "fan_in", gen)
    if init_type == "normal":
        return _normal(shape, _GAIN, gen)
    if init_type == "xavier_normal":
        return _variance_scaling(shape, 1.0, "fan_avg", gen)
    if init_type == "kaiming_normal":
        return _variance_scaling(shape, 2.0, "fan_in", gen)
    if init_type == "orthogonal":
        return _orthogonal(shape, _GAIN, gen)
    raise ValueError(f"unknown init type: {init_type}")


def _draw(path, shape, modules: Dict[str, nn.Module], gen):
    """One flax params leaf at ``path`` (a tuple of scope names)."""
    leaf = path[-1]
    if leaf == "bias":
        return torch.zeros(shape)
    if leaf == "scale" or leaf.endswith("/kernel/scale"):
        return torch.ones(shape)
    if len(path) >= 2 and re.fullmatch(r"[ih][ifgo]", path[-2]):
        if path[-2][0] == "h":
            return _orthogonal(shape, 1.0, gen)
        return _variance_scaling(shape, 1.0, "fan_in", gen)
    owner = path[:-1]
    parent = modules.get(".".join(owner[:-1]))
    if leaf == "embedding":
        if type(parent).__name__ == "SpeakerEmbedding":
            return _normal(shape, parent.std, gen)
        # flax Embed: in axis -2 and out axis 0 of (N, F) give fan_in F
        return _variance_scaling(shape, 1.0, "fan_in", gen, truncated=False,
                                 fans=(shape[-1], shape[0]))
    if leaf == "kernel":
        if (type(parent).__name__ == "PeriodicityEstimator"
                and owner[-1] == f"conv{parent.n - 1}"):
            return _normal(shape, _GATE_STD, gen)
        pattern = INIT_TYPE_LAYERS.get(type(parent).__name__)
        if pattern and re.fullmatch(pattern, owner[-1]):
            return _kernel(getattr(parent, "init_type", "none"), shape, gen)
        return _variance_scaling(shape, 1.0, "fan_in", gen)
    raise ValueError(f"flax_init: no scheme for {'/'.join(path)}")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


@torch.no_grad()
def init_variables(module: nn.Module, seed: int = 0) -> Dict:
    """Flax-layout variables (``{"params", "batch_stats"}``, nested dicts
    of float32 numpy arrays) for ``module``, drawn by the flax schemes from
    a ``torch.Generator`` seeded ``seed``; leaves are drawn in sorted path
    order."""
    template = torch_to_flax(module)
    modules = {name: m for name, m in module.named_modules()}
    gen = torch.Generator().manual_seed(int(seed))
    out: Dict = {"params": {}}
    for path, value in sorted(_leaves(template["params"])):
        _set(out["params"], path,
             _draw(path, tuple(value.shape), modules, gen).numpy())
    if "batch_stats" in template:
        out["batch_stats"] = {}
        for path, value in _leaves(template["batch_stats"]):
            fill = np.ones if path[-1] == "var" else np.zeros
            _set(out["batch_stats"], path, fill(value.shape, np.float32))
    return out


def init_module(module: nn.Module, seed: int = 0) -> nn.Module:
    """Draw ``module``'s weights in place by :func:`init_variables`;
    returns it."""
    return flax_to_torch(module, init_variables(module, seed))
