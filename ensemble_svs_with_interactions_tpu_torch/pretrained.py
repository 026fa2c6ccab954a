"""The packed-model registry: the port's copy of the local part of
``ensemble_svs_with_interactions_tpu/pretrained.py``.

Names resolve, in order, to

  1. local directories registered at run time (:func:`register_model`),
  2. the ``ESVS_MODEL_ROOT`` cache directory (default
     ``~/.cache/esvs_tpu``, the JAX package's), as ``name`` with ``/``
     replaced by ``_`` or as ``name`` itself,
  3. explicit paths.

The named entries of ``model_registry`` are NNSVS's published models.
A named entry whose pack is complete in the cache directory resolves as
above; one that is not there would be downloaded and converted, which
needs the JAX package's ``bin/enunu2nnsvs.py`` and ``utils/torch_port.py``:
the port has not ported them, and :func:`retrieve_pretrained_model`
raises ``NotImplementedError`` naming them.  It never downloads.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

DEFAULT_CACHE_DIR = Path(
    os.environ.get(
        "ESVS_MODEL_ROOT",
        os.path.join(os.path.expanduser("~"), ".cache", "esvs_tpu")))

# NNSVS's published models; ``_target_`` names the engine class
_PKG = "ensemble_svs_with_interactions_tpu_torch"
model_registry: Dict[str, dict] = {
    "r9y9/yoko_latest": {
        "url": "https://www.dropbox.com/s/k8mya65yt52m0ps/yoko_latest.tar.gz?dl=1",
        "_target_": f"{_PKG}.svs:SPSVS",
        "format": "torch",
    },
    "r9y9/20220322_yoko_timelag_mdn_duration_mdn_acoustic_resf0conv": {
        "url": "https://www.dropbox.com/s/olsfyqol9ryk5kx/"
        "20220322_yoko_timelag_mdn_duration_mdn_acoustic_resf0conv.tar.gz?dl=1",
        "_target_": f"{_PKG}.svs:SPSVS",
        "format": "torch",
    },
}

# what converting a downloaded NNSVS pack needs
UNPORTED_CONVERSION = ("ensemble_svs_with_interactions_tpu/bin/enunu2nnsvs.py"
                       " and ensemble_svs_with_interactions_tpu/utils/"
                       "torch_port.py")


def register_model(name: str, path, target: Optional[str] = None) -> None:
    """Register a local packed-model directory under a name."""
    model_registry[name] = {
        "path": str(path),
        "_target_": target or f"{_PKG}.svs:SPSVS",
        "format": "flax",
    }


def get_available_model_ids():
    return sorted(model_registry)


def _candidate_paths(name: str):
    """Local paths a name may resolve to, in resolution order (shared by
    :func:`is_pretrained_model_ready` and
    :func:`retrieve_pretrained_model`, so the two never disagree about
    what resolves without a download)."""
    entry = model_registry.get(name)
    cands = []
    if entry and entry.get("path"):
        cands.append(Path(entry["path"]))
    cands.append(DEFAULT_CACHE_DIR / name.replace("/", "_"))
    cands.append(DEFAULT_CACHE_DIR / name)
    cands.append(Path(name))
    return entry, cands


def _is_complete_pack(p: Path) -> bool:
    """A directory counts only when its pack is complete (a
    ``config.yaml``): a torn cache directory satisfies neither resolver."""
    return (p / "config.yaml").exists()


def is_pretrained_model_ready(name: str) -> bool:
    """True when a name resolves without any download: a registered local
    path, the cache directory or a direct path holds a complete pack."""
    _, cands = _candidate_paths(name)
    return any(_is_complete_pack(p) for p in cands)


def retrieve_pretrained_model(name: str) -> Path:
    """Resolve a model name to a packed-model directory.  A named entry
    not in the cache raises ``NotImplementedError``: its download and
    conversion are not ported."""
    entry, cands = _candidate_paths(name)
    for p in cands:
        if _is_complete_pack(p):
            return p
    if entry and entry.get("url"):
        raise NotImplementedError(
            f"{name} is not in the cache directory {DEFAULT_CACHE_DIR}; "
            f"downloading and converting it needs {UNPORTED_CONVERSION}, "
            "which the port has not ported")
    # directories without a config.yaml resolve last, so an incomplete
    # pack surfaces a load error instead of masking a registry entry
    for p in cands:
        if p.exists():
            return p
    raise ValueError(
        f"unknown pretrained model: {name}. Registered: "
        f"{get_available_model_ids()}; cache dir: {DEFAULT_CACHE_DIR}")


def create_svs_engine(name: str, **kwargs):
    """The SVS engine of a registry entry; ``kwargs`` go to its
    constructor (``device="cpu"`` for the CPU; the card otherwise)."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        resolve_target,
    )

    entry = model_registry.get(name, {})
    target = entry.get("_target_", f"{_PKG}.svs:SPSVS")
    cls = resolve_target(target.replace(":", "."))
    return cls(retrieve_pretrained_model(name), **kwargs)
