"""``_target_`` config instantiation for the port.

Configs are the JAX package's own dicts: a ``_target_`` such as
``ensemble_svs_with_interactions_tpu.models.FFConvLSTM`` resolves to the
port's class of the same module path
(``ensemble_svs_with_interactions_tpu_torch.models.FFConvLSTM``), so one
config dict builds both twins.  ``load_config`` / ``save_config`` read and
write the YAML files of packed model directories through the port's own
subset reader and writer (``utils/yaml_io.py``), with no ``yaml`` import.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict

from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io

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


def load_config(path) -> Config:
    """A YAML config file as a ``Config`` (an empty file gives ``{}``)."""
    return Config(yaml_io.load(Path(path).read_text()) or {})


def save_config(cfg: Dict, path) -> None:
    """Write ``cfg`` as ``yaml.safe_dump(cfg, sort_keys=False)`` would
    (tuples as lists)."""
    Path(path).write_text(yaml_io.dump(cfg))


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
