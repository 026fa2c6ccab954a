"""``_target_`` config instantiation for the port.

Configs are the JAX package's own dicts: a ``_target_`` such as
``ensemble_svs_with_interactions_tpu.models.FFConvLSTM`` resolves to the
port's class of the same module path
(``ensemble_svs_with_interactions_tpu_torch.models.FFConvLSTM``), so one
config dict builds both twins.  ``load_config`` / ``save_config`` read and
write YAML files (packed model directories, trainer configs) through the
port's own subset reader and writer (``utils/yaml_io.py``), with no
``yaml`` import.  ``merge`` and ``parse_overrides`` give the CLIs their
``key=value`` overrides, with the JAX package's typing of values.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict, List

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

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, dotted: str, default=None):
        """The value at a dotted key path, or ``default`` where it breaks
        off."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _wrap(obj):
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def load_config(path) -> Config:
    """A YAML config file as a ``Config`` (an empty file gives ``{}``)."""
    return _wrap(yaml_io.load(Path(path).read_text()) or {})


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


def merge(base: Dict, override: Dict) -> Config:
    """Deep-merge ``override`` into ``base`` (returns a new Config)."""
    out = Config({})
    for k, v in base.items():
        out[k] = _wrap(v)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = _wrap(v)
    return out


def _override_value(raw: str):
    """Type a CLI override as the JAX package does: ints, floats (with
    dotless exponents such as ``1e-4``), true/false/null, a flow list or
    map through the YAML reader, and anything else verbatim (no on/off/
    yes/no booleans)."""
    s = raw.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s[:1] in ("[", "{"):
        return yaml_io.load(s)
    return raw


def parse_overrides(args: List[str]) -> Config:
    """Parse ``a.b=value`` strings into a nested Config."""
    out: Dict = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must look like key=value: {arg}")
        key, _, raw = arg.partition("=")
        value = _override_value(raw)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _wrap(out)
