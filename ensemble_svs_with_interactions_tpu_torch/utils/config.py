"""``_target_`` config instantiation for the port.

Configs are the JAX package's own dicts: a ``_target_`` such as
``ensemble_svs_with_interactions_tpu.models.FFConvLSTM`` resolves to the
port's class of the same module path
(``ensemble_svs_with_interactions_tpu_torch.models.FFConvLSTM``), so one
config dict builds both twins.  No YAML here: configs arrive in memory.
"""

from __future__ import annotations

import importlib
from typing import Any

_JAX_PKG = "ensemble_svs_with_interactions_tpu"
_PKG = "ensemble_svs_with_interactions_tpu_torch"


class Config(dict):
    """dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[name] = v
        return v


def resolve_target(path: str) -> Any:
    """Import a dotted ``_target_``; the JAX package's prefix maps to the
    port's."""
    if path.startswith(_JAX_PKG + "."):
        path = _PKG + path[len(_JAX_PKG):]
    mod_name, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(mod_name), attr)


def instantiate(node: Any, **overrides) -> Any:
    """Recursively instantiate ``_target_`` config nodes (nested sub-model
    configs are built first and passed in as modules)."""
    if isinstance(node, dict) and "_target_" in node:
        cls = resolve_target(node["_target_"])
        kwargs = {k: instantiate(v) for k, v in node.items()
                  if k != "_target_"}
        kwargs.update(overrides)
        return cls(**kwargs)
    if isinstance(node, dict):
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node
