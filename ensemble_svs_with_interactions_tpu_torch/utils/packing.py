"""Packed-model directory writer: the port's counterpart of
``ensemble_svs_with_interactions_tpu/utils/packing.py``, writing the same
files with no ``yaml``, ``msgpack`` or ``flax`` import, so that the JAX
package's ``SPSVS(model_dir)`` and the port's open what either wrote:

    config.yaml                                 # global config
    qst.hed                                     # question set
    {phase}_model.yaml                          # netG config + stream info
    {phase}_model.params                        # flax msgpack variables
    in_{phase}_scaler_{min,scale}.npy           # MinMax input scaler
    out_{phase}_scaler_{mean,var,scale}.npy     # Standard output scaler
    in_vocoder_scaler_{mean,var,scale}.npy      # a vocoder's Standard one

Each scaler is written by its type (``utils/scalers.save_scaler``), so a
``vocoder`` phase with a ``StandardScaler`` in-scaler writes what
``svs.load_vocoder`` reads back.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, Optional, Union

from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import save_config
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
    StandardScaler,
    save_scaler,
)


def save_model_phase(
    out_dir,
    phase: str,
    model_config: Dict,
    variables,
    in_scaler: Optional[Union[MinMaxScaler, StandardScaler]] = None,
    out_scaler: Optional[StandardScaler] = None,
) -> None:
    """Write one phase: its config, its flax-layout ``variables`` and its
    scalers."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_config(model_config, out_dir / f"{phase}_model.yaml")
    with open(out_dir / f"{phase}_model.params", "wb") as f:
        flax_msgpack.dump(variables, f)
    if in_scaler is not None:
        save_scaler(in_scaler, str(out_dir / f"in_{phase}_scaler"))
    if out_scaler is not None:
        save_scaler(out_scaler, str(out_dir / f"out_{phase}_scaler"))


def pack_model(
    out_dir,
    global_config: Dict,
    qst_path,
    phases: Dict[str, Dict],
) -> Path:
    """Write a complete packed-model directory.

    Args:
        out_dir: destination directory.
        global_config: top-level config (sample_rate, frame_period, ...).
        qst_path: path to the question set (.hed) to bundle.
        phases: mapping phase -> dict(model_config, in_scaler, out_scaler,
            and the weights as either ``module``, a module of the port
            (written through ``torch_to_flax``), or ``variables``, flax
            variables).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_config(global_config, out_dir / "config.yaml")
    shutil.copyfile(qst_path, out_dir / "qst.hed")
    for phase, parts in phases.items():
        variables = (parts["variables"] if "variables" in parts
                     else torch_to_flax(parts["module"]))
        save_model_phase(out_dir, phase, parts["model_config"], variables,
                         parts.get("in_scaler"), parts.get("out_scaler"))
    return out_dir
