"""Convert an ENUNU voicebank, or a reference NNSVS packed model, into a
packed directory that either package's ``SPSVS(model_dir)`` serves.

The port's copy of ``ensemble_svs_with_interactions_tpu/bin/enunu2nnsvs.py``,
writing the same files: the question set and kana table are copied, the
joblib scalers become ``.npy`` files (``{in,out}_{phase}_scaler_{mean,var,
scale}.npy`` / ``_{min,scale}.npy``), each phase's ``model.yaml`` is kept
with its ``_target_`` translated to the JAX package's names, and a
synthesis ``config.yaml`` is written.

Torch checkpoints are ported when the architecture maps 1:1 onto the model
zoo (``utils/torch_port.py``: Linear / Conv1d / LSTM / BatchNorm units
matched in definition order) into flax-layout ``.params``, so the
converted voice synthesizes directly.  ``main`` keeps a checkpoint that
does not port as ``{phase}_model.pth.orig`` with a note.

``convert_nnsvs_pack`` (a reference pack: ``config.yaml``,
``{phase}_model.{yaml,pth}`` and ``.npy`` scalers, the published tarballs'
layout) needs only torch and NumPy; ``main`` (an ENUNU voicebank) also
needs ``joblib`` to read its scikit-learn scalers.

Usage: python -m ...bin.enunu2nnsvs <enunu_dir> <out_dir> [--no-port-weights]
"""

from __future__ import annotations

import argparse
import inspect
import shutil
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io


def scaler_to_npy(joblib_path: Path, out_dir: Path) -> str:
    """Duck-typed joblib scaler -> npy files; returns the kind converted."""
    try:
        import joblib
    except ImportError as e:
        raise ImportError(
            f"reading {joblib_path} needs joblib (and scikit-learn for its "
            "scalers); convert_nnsvs_pack reads .npy scalers without "
            "them") from e

    scaler = joblib.load(joblib_path)
    stem = joblib_path.stem
    if hasattr(scaler, "mean_") and hasattr(scaler, "var_"):
        np.save(out_dir / f"{stem}_mean.npy", np.asarray(scaler.mean_))
        np.save(out_dir / f"{stem}_var.npy", np.asarray(scaler.var_))
        np.save(out_dir / f"{stem}_scale.npy", np.asarray(scaler.scale_))
        return "standard"
    if hasattr(scaler, "min_") and hasattr(scaler, "scale_"):
        np.save(out_dir / f"{stem}_min.npy", np.asarray(scaler.min_))
        np.save(out_dir / f"{stem}_scale.npy", np.asarray(scaler.scale_))
        return "minmax"
    raise ValueError(f"unknown scaler type in {joblib_path}: {type(scaler)}")


# reference names -> the JAX package's, which the port resolves to its own
# classes and the JAX package to its flax twins
_TARGET_MAP = (
    ("nnsvs.acoustic_models.",
     "ensemble_svs_with_interactions_tpu.models.acoustic."),
    ("nnsvs.model.", "ensemble_svs_with_interactions_tpu.models."),
)


def translate_target(target: str) -> str:
    for old, new in _TARGET_MAP:
        if target.startswith(old):
            return new + target[len(old):]
    return target


def _init_params(cls) -> set:
    """The constructor's named parameters: the config keys the class
    takes (the JAX package reads its flax dataclass fields)."""
    return {name for name, p in inspect.signature(cls.__init__).parameters
            .items() if name != "self"
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def try_port_phase(phase: str, model_yaml: dict, ckpt_path: Path,
                   out_dir: Path) -> int:
    """Port a reference torch checkpoint onto the port's model of the same
    architecture and write the phase (``{phase}_model.yaml`` and
    ``.params``).

    Returns the number of layer units ported, or raises on any mismatch
    (unknown architecture, field or shape drift).
    """
    from collections.abc import Mapping

    import torch

    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        _wrap,
        instantiate,
        resolve_target,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        save_model_phase,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.torch_port import (
        template_variables,
        torch_to_flax,
    )

    netG = dict(model_yaml["netG"])
    netG["_target_"] = translate_target(str(netG["_target_"]))
    # drop config keys the class does not take (torch-only knobs)
    fields = _init_params(resolve_target(netG["_target_"]))
    netG = {k: v for k, v in netG.items() if k == "_target_" or k in fields}
    # translate nested submodule configs too (composite models)
    scope_pairs = []
    for k, v in list(netG.items()):
        if isinstance(v, Mapping) and "_target_" in v:
            sub = dict(v)
            sub["_target_"] = translate_target(str(sub["_target_"]))
            sub_fields = _init_params(resolve_target(sub["_target_"]))
            netG[k] = {kk: vv for kk, vv in sub.items()
                       if kk == "_target_" or kk in sub_fields}
            scope_pairs.append((f"{k}.", f"/{k}"))
    if "compat_sub_encoder_outs" in fields:
        # reference-trained weights expect the reference's sub-track
        # encoder routing
        netG["compat_sub_encoder_outs"] = True
    module = instantiate(_wrap(netG))
    template = template_variables(module)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {(k[len("module."):] if k.startswith("module.") else k): v.numpy()
          for k, v in sd.items()}
    variables, n_units = torch_to_flax(sd, template,
                                       scope_pairs=scope_pairs or None)
    cfg_out = dict(model_yaml)
    cfg_out["netG"] = netG
    save_model_phase(out_dir, phase, cfg_out, variables)
    return n_units


def convert_nnsvs_pack(src_dir, out_dir):
    """Convert a reference NNSVS packed-model directory (config.yaml +
    ``{phase}_model.{yaml,pth}`` + .npy scalers, the layout of the
    published pretrained tarballs) into a runnable pack.  Returns the list
    of (phase, units) ported."""
    src_dir, out_dir = Path(src_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("config.yaml", "qst.hed"):
        if (src_dir / name).exists():
            shutil.copyfile(src_dir / name, out_dir / name)
    for npy in src_dir.glob("*_scaler_*.npy"):
        shutil.copyfile(npy, out_dir / npy.name)
    ported = []
    for phase in ("timelag", "duration", "acoustic", "postfilter"):
        yaml_path = src_dir / f"{phase}_model.yaml"
        ckpt = src_dir / f"{phase}_model.pth"
        if not yaml_path.exists() or not ckpt.exists():
            continue
        model_yaml = yaml_io.load(yaml_path.read_text())
        n = try_port_phase(phase, model_yaml, ckpt, out_dir)
        ported.append((phase, n))
    if not ported:
        raise ValueError(f"no portable phases found in {src_dir}")
    return ported


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("enunu_dir")
    ap.add_argument("out_dir")
    ap.add_argument(
        "--no-port-weights",
        action="store_true",
        help="skip the torch->flax weight port and only copy configs/scalers",
    )
    args = ap.parse_args(argv)
    enunu_dir, out_dir = Path(args.enunu_dir), Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    enuconfig = yaml_io.load((enunu_dir / "enuconfig.yaml").read_text())

    shutil.copyfile(enunu_dir / enuconfig["question_path"],
                    out_dir / "qst.hed")
    table = enunu_dir / enuconfig.get("table_path", "")
    if table.is_file():
        shutil.copyfile(table, out_dir / "kana2phonemes.table")

    model_dir = enunu_dir / enuconfig["model_dir"]
    pending = []
    ported = []
    for phase in ("timelag", "duration", "acoustic"):
        model_yaml = yaml_io.load(
            (model_dir / phase / "model.yaml").read_text())
        shutil.copyfile(model_dir / phase / "model.yaml",
                        out_dir / f"{phase}_model.yaml")
        ckpt = model_dir / phase / enuconfig[phase]["checkpoint"]
        if ckpt.exists():
            done = False
            if not args.no_port_weights:
                try:
                    n = try_port_phase(phase, model_yaml, ckpt, out_dir)
                    ported.append((phase, n))
                    done = True
                except Exception as e:  # noqa: BLE001 — fall back to copy
                    print(f"{phase}: weight port failed ({e}); keeping .orig")
            if not done:
                shutil.copyfile(ckpt, out_dir / f"{phase}_model.pth.orig")
                pending.append(phase)
        for inout in ("in", "out"):
            scaler_to_npy(
                enunu_dir / enuconfig["stats_dir"]
                / f"{inout}_{phase}_scaler.joblib",
                out_dir,
            )

    config = {
        "sample_rate": enuconfig["sample_rate"],
        "frame_period": 5,
        "log_f0_conditioning": enuconfig.get("log_f0_conditioning", True),
        "use_world_codec": False,
        "timelag": {
            "allowed_range": enuconfig["timelag"]["allowed_range"],
            "allowed_range_rest": enuconfig["timelag"]["allowed_range_rest"],
            "force_clip_input_features": True,
        },
        "duration": {"force_clip_input_features": True},
        "acoustic": {
            "subphone_features": "coarse_coding",
            "force_clip_input_features": True,
            "relative_f0": enuconfig["acoustic"].get("relative_f0", True),
        },
    }
    (out_dir / "config.yaml").write_text(yaml_io.dump(config))

    print(f"converted configs + scalers -> {out_dir}")
    for phase, n in ported:
        print(f"{phase}: ported {n} torch layer units to flax params")
    if pending:
        print(
            "NOTE: torch checkpoints copied as *_model.pth.orig for phases "
            f"{pending}; flax weights must be re-trained or ported per "
            "architecture before synthesis."
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
