"""Staged recipe runner: data prep -> features -> scalers -> training ->
packing -> synthesis, driven by one YAML config; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/run_recipe.py``.

  -1 corpus data preparation (jaCappella-style multitrack segmentation,
     song-level splits; cfg.data_prep section)
  0  split utterance lists (train_no_dev / dev / eval); when
     cfg.data.lists_dir is set (e.g. written by stage -1), the song-level
     lists are copied instead of re-split
  1  feature extraction (prepare_features; multitrack adds note times)
  2  fit scalers + normalize features
  3  train time-lag model
  4  train duration model
  5  train acoustic model
  6  pack models into an SPSVS directory
  7  synthesis smoke run on eval utterances (pairwise multitrack synthesis
     when cfg.multitrack)
  8  prepare postfilter training pairs: the packed acoustic model's
     predicted statics against the ground-truth statics, both normalized
     by the static scaler (single-track recipes)
  9  train the learned postfilter (cfg.postfilter, or a default
     Conv2dPostFilter / Conv2dD pair) and pack it beside the SVS models
  10 prepare vocoder features + train a uSFGAN-family vocoder, packed
     beside the SVS models
  11 timing evaluation: dump predicted timelag/duration for objective
     scoring, then ``QUALITY.json`` from the phases' dev metrics

The training, synthesis, postfilter, vocoder and timing stages run on the
recipe's ``device`` (``cuda`` unless the recipe or an override says
``cpu``).  A multitrack recipe has no postfilter stages: a range that
reaches stage 8 raises the JAX runner's ``ValueError`` before any stage
runs, and one that reaches stage 9 a ``ValueError`` too (JAX's stage 9
fails later, for want of stage 8's pairs).

The recipe file is read with the port's YAML subset (``utils/yaml_io``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.run_recipe
       recipe.yaml [--stage N] [--stop-stage M] [key=value ...]
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    _wrap,
    load_config,
    merge,
    parse_overrides,
    save_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.logger import getLogger

logger = getLogger(verbose=1, name="recipe")

# the JAX runner's refusal (bin/run_recipe.py stage8_postfilter_features)
MULTITRACK_POSTFILTER = (
    "stage 8 (postfilter features) does not support multitrack "
    "recipes: the cross-conditioned acoustic model needs a sub "
    "track per utterance. Train the postfilter on a single-track "
    "recipe (reference parity: multitrack run.sh has no postfilter "
    "stage).")
MULTITRACK_POSTFILTER_TRAIN = (
    "stage 9 (postfilter training) trains on stage 8's postfilter pairs, "
    "which a multitrack recipe does not make: train the postfilter on a "
    "single-track recipe.")


def _device(cfg: Config) -> str:
    """The recipe's ``device``: ``cuda`` unless it asks for another."""
    return str(cfg.get("device", "cuda"))


def stage_m1_data_prep(cfg: Config, work: Path):
    """Corpus preparation (reference recipes/_common/db/jaCappella_multi)."""
    dp = cfg.get("data_prep", None)
    if not dp:
        logger.info("stage -1: no cfg.data_prep section, skipping")
        return
    from ensemble_svs_with_interactions_tpu_torch.bin.data_prep_multitrack import (
        prepare_corpus,
    )

    out_dir = Path(dp.get("out_dir") or (work / "data"))
    prepare_corpus(
        dp.corpus_root,
        out_dir,
        list(dp.spk_list),
        silence_threshold=float(dp.get("silence_threshold", 1.0)),
        force_split_threshold=float(dp.get("force_split_threshold", 8.0)),
        timelag_allowed_range=tuple(dp.get("timelag_allowed_range", (-20, 19))),
        timelag_allowed_range_rest=tuple(
            dp.get("timelag_allowed_range_rest", (-40, 39))
        ),
        offset_correction_threshold=float(
            dp.get("offset_correction_threshold", 0.01)
        ),
        global_offset_correction=bool(dp.get("global_offset_correction", False)),
        sample_rate=int(dp.get("sample_rate", 0)),
        dev_songs=list(dp.get("dev_songs", []) or []),
        eval_songs=list(dp.get("eval_songs", []) or []),
    )
    logger.info("stage -1: corpus prepared at %s", out_dir)


def stage0_utt_lists(cfg: Config, work: Path):
    """Split the utterance list into train_no_dev / dev / eval.

    When ``cfg.data.lists_dir`` is set (stage -1 writes song-level splits
    there), the existing lists are copied verbatim — the reference's
    split_by_song_multitrack keeps all segments of a song in one split.
    """
    lists_dir = cfg.data.get("lists_dir", None)
    if lists_dir:
        lists = work / "lists"
        lists.mkdir(parents=True, exist_ok=True)
        for name in ("train_no_dev", "dev", "eval"):
            shutil.copyfile(
                Path(lists_dir) / f"{name}.list", lists / f"{name}.list"
            )
        logger.info("stage 0: song-level lists copied from %s", lists_dir)
        return
    utts = [
        line.strip()
        for line in open(cfg.data.utt_list)
        if line.strip()
    ]
    n_dev = int(cfg.data.get("n_dev", max(1, len(utts) // 10)))
    n_eval = int(cfg.data.get("n_eval", max(1, len(utts) // 10)))
    rng = np.random.default_rng(int(cfg.get("seed", 1234)))
    order = list(utts)
    if cfg.data.get("shuffle_utt_list", False):
        rng.shuffle(order)
    eval_utts = order[:n_eval]
    dev_utts = order[n_eval : n_eval + n_dev]
    train_utts = order[n_eval + n_dev :]
    lists = work / "lists"
    lists.mkdir(parents=True, exist_ok=True)
    for name, items in (
        ("train_no_dev", train_utts),
        ("dev", dev_utts),
        ("eval", eval_utts),
    ):
        (lists / f"{name}.list").write_text("\n".join(items) + "\n")
    logger.info(
        "stage 0: %d train / %d dev / %d eval",
        len(train_utts), len(dev_utts), len(eval_utts),
    )


def stage1_features(cfg: Config, work: Path):
    from ensemble_svs_with_interactions_tpu_torch.bin import prepare_features

    for split in ("train_no_dev", "dev", "eval"):
        feat_cfg = merge(
            cfg.features,
            {
                "utt_list": str(work / "lists" / f"{split}.list"),
                "out_dir": str(work / "dump" / split / "org"),
                "question_path": cfg.question_path,
                "save_note_times": bool(cfg.get("multitrack", False)),
            },
        )
        prepare_features.run(feat_cfg)
    logger.info("stage 1: features extracted")


def stage2_scalers(cfg: Config, work: Path):
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        fit_scaler,
        preprocess_normalize,
    )

    dump = work / "dump"
    scaler_types = {
        "in_timelag": "minmax",
        "out_timelag": "standard",
        "in_duration": "minmax",
        "out_duration": "standard",
        "in_acoustic": "minmax",
        "out_acoustic": "standard",
    }
    for phase, kind in scaler_types.items():
        src = dump / "train_no_dev" / "org" / phase
        prefix = work / "scalers" / f"{phase}_scaler"
        prefix.parent.mkdir(parents=True, exist_ok=True)
        fit_scaler.main([str(src), str(prefix), "--type", kind])
        for split in ("train_no_dev", "dev", "eval"):
            in_dir = dump / split / "org" / phase
            out_dir = dump / split / "norm" / phase
            preprocess_normalize.main(
                [str(in_dir), str(prefix), str(out_dir), "--type", kind]
            )
    logger.info("stage 2: scalers fit + features normalized")


def _train_cfg(cfg, work, phase: str) -> Config:
    dump = work / "dump"
    model_cfg = load_config(cfg[phase].model_config)
    train_cfg = dict(cfg[phase].get("train", {}))
    data_over = {
        "train_no_dev": {
            "in_dir": str(dump / "train_no_dev" / "norm" / f"in_{phase}"),
            "out_dir": str(dump / "train_no_dev" / "norm" / f"out_{phase}"),
        },
        "dev": {
            "in_dir": str(dump / "dev" / "norm" / f"in_{phase}"),
            "out_dir": str(dump / "dev" / "norm" / f"out_{phase}"),
        },
        "out_scaler_prefix": str(work / "scalers" / f"out_{phase}_scaler"),
    }
    data_over.update(dict(cfg[phase].get("data", {})))
    return merge(
        {"seed": cfg.get("seed", 1234), "verbose": cfg.get("verbose", 1)},
        {
            "model": dict(model_cfg),
            "data": data_over,
            "train": {**train_cfg, "out_dir": str(work / "exp" / phase)},
        },
    )


def _resolve_lf0_stats(cfg, work, model_cfg: Config):
    """Fill in_lf0_min/max and out_lf0_mean/scale from the fitted scalers
    where the model config leaves them ``None``."""
    netG = model_cfg.model.netG
    in_lf0_idx = netG.get("in_lf0_idx")
    out_lf0_idx = netG.get("out_lf0_idx")
    if in_lf0_idx is None or out_lf0_idx is None:
        return model_cfg
    smin = np.load(work / "scalers" / "in_acoustic_scaler_min.npy")
    sscale = np.load(work / "scalers" / "in_acoustic_scaler_scale.npy")
    # MinMax: min_, scale_ -> data range
    data_min = -smin / sscale
    data_max = (1.0 - smin) / sscale
    mean = np.load(work / "scalers" / "out_acoustic_scaler_mean.npy")
    scale = np.load(work / "scalers" / "out_acoustic_scaler_scale.npy")
    stats = {
        "in_lf0_min": float(data_min[in_lf0_idx]),
        "in_lf0_max": float(data_max[in_lf0_idx]),
        "out_lf0_mean": float(mean[out_lf0_idx]),
        "out_lf0_scale": float(scale[out_lf0_idx]),
    }

    def fill(node):
        if isinstance(node, dict):
            for k, v in list(node.items()):
                if k in stats and (v is None):
                    node[k] = stats[k]
                else:
                    fill(v)

    fill(netG)
    return model_cfg


def _phase_cfg(cfg, work, phase: str) -> Config:
    phase_cfg = _train_cfg(cfg, work, phase)
    if phase == "acoustic":
        phase_cfg = _resolve_lf0_stats(cfg, work, phase_cfg)
    return phase_cfg


def _train_phase(cfg, work, phase: str):
    """Train ``phase`` on the recipe's device: the multitrack trainer when
    ``cfg.multitrack`` is set, else the single-track one."""
    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack_trainer,
        trainer,
    )

    train = (multitrack_trainer.train_multitrack_model
             if cfg.get("multitrack", False) else trainer.train_model)
    train(_phase_cfg(cfg, work, phase), is_acoustic=phase == "acoustic",
          device=_device(cfg))


def stage3_train_timelag(cfg, work):
    _train_phase(cfg, work, "timelag")
    logger.info("stage 3: timelag model trained")


def stage4_train_duration(cfg, work):
    _train_phase(cfg, work, "duration")
    logger.info("stage 4: duration model trained")


def stage5_train_acoustic(cfg, work):
    _train_phase(cfg, work, "acoustic")
    logger.info("stage 5: acoustic model trained")


def _restore(template, state, path="/"):
    """``state``'s leaves in the structure of ``template`` (flax's
    ``from_state_dict``): the same keys at every level, or ValueError."""
    if not isinstance(template, dict):
        if np.shape(state) != np.shape(template):
            raise ValueError(f"{path}: checkpoint shape {np.shape(state)}, "
                             f"model {np.shape(template)}")
        return state
    if set(template) != set(state):
        raise ValueError(f"{path}: checkpoint keys {sorted(state)} differ "
                         f"from the model's {sorted(template)}")
    return {k: _restore(v, state[k], f"{path}{k}/")
            for k, v in template.items()}


def stage6_pack(cfg, work):
    """Collect trained checkpoints + scalers into a packed model dir."""
    from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_variables,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        save_model_phase,
    )

    packed = work / "packed_model"
    packed.mkdir(parents=True, exist_ok=True)
    ac_params = cfg.features.acoustic.params
    dp = cfg.get("data_prep", {}) or {}
    save_config(
        {
            "sample_rate": int(ac_params.get("sample_rate", 48000)),
            "frame_period": float(ac_params.get("frame_period", 5)),
            "feature_type": "world",
            "use_world_codec": bool(ac_params.get("use_world_codec", True)),
            "relative_f0": bool(ac_params.get("relative_f0", False)),
            # synthesis-time flags the engine reads back
            "log_f0_conditioning": bool(
                cfg.features.get("log_f0_conditioning", True)
            ),
            "timelag": {
                # clip synthesis lags to the range the training targets
                # were clipped to in data prep
                "allowed_range": list(
                    dp.get("timelag_allowed_range", (-20, 20))
                ),
                "allowed_range_rest": list(
                    dp.get("timelag_allowed_range_rest", (-40, 40))
                ),
                "force_clip_input_features": True,
            },
            "duration": {"force_clip_input_features": True},
            "acoustic": {
                "subphone_features": str(
                    ac_params.get("subphone_features", "coarse_coding")
                    or "none"
                ),
                "relative_f0": bool(ac_params.get("relative_f0", False)),
                "force_clip_input_features": True,
            },
        },
        packed / "config.yaml",
    )
    shutil.copyfile(cfg.question_path, packed / "qst.hed")

    for phase in ("timelag", "duration", "acoustic"):
        phase_cfg = _phase_cfg(cfg, work, phase)
        # the flax-layout variables of the model (the trainers' start),
        # as the JAX runner's template from its module.init
        template = init_variables(instantiate(phase_cfg.model.netG))
        ckpt = work / "exp" / phase / "best_loss.ckpt"
        tree = flax_msgpack.from_bytes(ckpt.read_bytes())
        variables = dict(template)
        variables["params"] = _restore(template["params"], tree["params"])
        if "batch_stats" in template and tree.get("batch_stats"):
            variables["batch_stats"] = _restore(template["batch_stats"],
                                                tree["batch_stats"])
        save_model_phase(packed, phase, dict(phase_cfg.model), variables)
        # scalers
        for prefix, names in (
            (f"in_{phase}", ("min", "scale")),
            (f"out_{phase}", ("mean", "var", "scale")),
        ):
            for n in names:
                src = work / "scalers" / f"{prefix}_scaler_{n}.npy"
                shutil.copyfile(src, packed / f"{prefix}_scaler_{n}.npy")
    logger.info("stage 6: packed model at %s", packed)


def stage7_synthesis(cfg, work):
    label_dir = cfg.get_path("synthesis.label_dir") or cfg.timelag_label_dir
    out_dir = work / "synthesis"
    device = ["--device", _device(cfg)]
    if cfg.get("multitrack", False):
        # pairwise cross-conditioned synthesis over same-segment singer
        # pairs
        from ensemble_svs_with_interactions_tpu_torch.bin import (
            synthesis_multitrack,
        )

        spk_names = cfg.get("spk_list", None) or cfg.get("synthesis", {}).get(
            "spk_names", None
        )
        if not spk_names:
            raise ValueError(
                "multitrack stage 7 needs the singer names: set `spk_list:` "
                "(or `synthesis.spk_names:`) in the recipe config"
            )
        synthesis_multitrack.main(
            [
                str(work / "packed_model"),
                str(label_dir),
                str(out_dir),
                "--spk-names",
                ",".join(spk_names),
                "--verbose",
                "1",
                *device,
            ]
        )
    else:
        from ensemble_svs_with_interactions_tpu_torch.bin import synthesis

        synthesis.main(
            [str(work / "packed_model"), str(label_dir), str(out_dir),
             "--verbose", "1", *device]
        )
    logger.info("stage 7: synthesis outputs at %s", out_dir)


def _refuse_multitrack(cfg, first: int, last: int):
    """A multitrack recipe's range that reaches stage 8 or 9 raises before
    any stage runs."""
    if not cfg.get("multitrack", False):
        return
    if first <= 8 <= last:
        raise ValueError(MULTITRACK_POSTFILTER)
    if first <= 9 <= last:
        raise ValueError(MULTITRACK_POSTFILTER_TRAIN)


def stage8_postfilter_features(cfg, work):
    """Paired postfilter training data in the normalized static domain
    (where ``gen.postprocess_acoustic`` applies the learned postfilter):
    the packed acoustic model's predicted statics (run on the recipe's
    device, one utterance at a time, denormalized with MLPG where deltas
    are modeled) as input, the ground-truth statics as target; and the
    static scaler as ``scalers/out_postfilter_scaler_*``."""
    from ensemble_svs_with_interactions_tpu_torch import gen
    from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
        get_static_features,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        extract_static_scaler,
    )

    _refuse_multitrack(cfg, 8, 8)
    engine = SPSVS(work / "packed_model", device=_device(cfg))
    model = engine.acoustic_model
    mc = model.config
    static_scaler = extract_static_scaler(
        engine.out_acoustic_scaler, mc.stream_sizes, mc.has_dynamic_features,
        mc.num_windows)
    is_prob = gen._is_probabilistic(model)

    def statics(feats):
        if np.any(list(mc.has_dynamic_features)):
            parts = get_static_features(
                feats[None], int(mc.num_windows), list(mc.stream_sizes),
                list(mc.has_dynamic_features))
            return np.concatenate([np.asarray(p)[0] for p in parts], axis=-1)
        return feats

    dump = work / "dump"
    for split in ("train_no_dev", "dev"):
        in_dir = dump / split / "norm" / "in_acoustic"
        gt_dir = dump / split / "org" / "out_acoustic"
        pred_out = work / "postfilter" / split / "in_postfilter"
        gt_out = work / "postfilter" / split / "out_postfilter"
        pred_out.mkdir(parents=True, exist_ok=True)
        gt_out.mkdir(parents=True, exist_ok=True)
        n = 0
        for path in sorted(in_dir.glob("*-feats.npy")):
            gt_path = gt_dir / path.name
            if not gt_path.exists():
                continue
            pred = model.inference(np.load(path).astype(np.float32))
            pred = gen._denorm_and_mlpg(pred, engine.out_acoustic_scaler, mc,
                                        is_prob)
            np.save(pred_out / path.name, np.asarray(
                static_scaler.transform(statics(pred)), np.float32))
            gt = statics(np.load(gt_path).astype(np.float32))
            np.save(gt_out / path.name,
                    np.asarray(static_scaler.transform(gt), np.float32))
            n += 1
        logger.info("stage 8 [%s]: %d postfilter pairs", split, n)

    scalers = work / "scalers"
    scalers.mkdir(exist_ok=True)
    for name in ("mean", "var", "scale"):
        np.save(scalers / f"out_postfilter_scaler_{name}.npy",
                np.asarray(getattr(static_scaler, f"{name}_")))


# the JAX runner's stage-9 pair when the recipe names none
DEFAULT_POSTFILTER = {
    "netG": {"_target_": ("ensemble_svs_with_interactions_tpu.models."
                          "postfilters.Conv2dPostFilter"),
             "channels": 64},
    "netD": {"_target_": ("ensemble_svs_with_interactions_tpu.models."
                          "discriminators.Conv2dD"),
             "channels": 32, "padding": None},
}


def postfilter_train_config(cfg, work) -> Config:
    """Stage 9's trainer config: stage 8's pairs, the recipe's
    ``postfilter.model`` (or ``DEFAULT_POSTFILTER``), ``exp/postfilter``
    and Adam at 1e-4 for 10 epochs, under the recipe's ``postfilter.data``
    and ``postfilter.train``."""
    pf = cfg.get("postfilter", None)
    pf = dict(pf) if pf else {}
    if pf.get("model_config") and not pf.get("model"):
        raise FileNotFoundError(
            f"postfilter.model_config not found: {pf['model_config']}")
    adam = {"optimizer": {"name": "Adam", "params": {"lr": 1e-4}}}
    train_cfg = _wrap({
        "seed": int(cfg.get("seed", 1234)),
        "verbose": int(cfg.get("verbose", 1)),
        "data": {
            "train_no_dev": {
                "in_dir": str(work / "postfilter/train_no_dev/in_postfilter"),
                "out_dir": str(work /
                               "postfilter/train_no_dev/out_postfilter"),
            },
            "dev": {
                "in_dir": str(work / "postfilter/dev/in_postfilter"),
                "out_dir": str(work / "postfilter/dev/out_postfilter"),
            },
            **dict(pf.get("data", {}) or {}),
        },
        "model": pf.get("model") or DEFAULT_POSTFILTER,
        "train": {
            "out_dir": str(work / "exp" / "postfilter"),
            "nepochs": 10,
            "optim": {"netG": adam, "netD": adam, "clip_norm": 1.0},
            **dict(pf.get("train", {}) or {}),
        },
    })
    if train_cfg.train.out_dir is None:
        train_cfg.train.out_dir = str(work / "exp" / "postfilter")
    return train_cfg


def pack_postfilter(train_cfg, packed_dir):
    """Stage 9's pack: G of ``train_cfg.train.out_dir/best_loss.ckpt`` as
    the ``postfilter`` phase (``{"netG": ...}``) of ``packed_dir``."""
    from ensemble_svs_with_interactions_tpu_torch.train.postfilter_trainer import (  # noqa: E501
        build_postfilter,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
        flax_to_torch,
        torch_to_flax,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        save_model_phase,
    )

    netG = build_postfilter(train_cfg)
    tree = flax_msgpack.from_bytes(
        (Path(train_cfg.train.out_dir) / "best_loss.ckpt").read_bytes())
    flax_to_torch(netG, {"params": tree["params"]})
    save_model_phase(packed_dir, "postfilter",
                     {"netG": dict(train_cfg.model.netG)},
                     torch_to_flax(netG))


def stage9_train_postfilter(cfg, work):
    """Train the learned postfilter on the recipe's device and pack it,
    with the ``out_postfilter`` scalers, beside the SVS models.  The pack
    reads the checkpoint where the trainer wrote it (``postfilter.train.
    out_dir`` where the recipe sets one; the JAX runner reads
    ``exp/postfilter`` whatever the trainer's directory)."""
    from ensemble_svs_with_interactions_tpu_torch.train.postfilter_trainer import (  # noqa: E501
        train_postfilter,
    )

    _refuse_multitrack(cfg, 9, 9)
    train_cfg = postfilter_train_config(cfg, work)
    train_postfilter(train_cfg, device=_device(cfg))
    packed = work / "packed_model"
    pack_postfilter(train_cfg, packed)
    for name in ("mean", "var", "scale"):
        shutil.copyfile(work / "scalers" / f"out_postfilter_scaler_{name}.npy",
                        packed / f"out_postfilter_scaler_{name}.npy")
    logger.info("stage 9: postfilter trained at %s and packed",
                train_cfg.train.out_dir)


def stage10_train_vocoder(cfg, work):
    """Prepare vocoder features, train a uSFGAN-family vocoder on the
    recipe's device and pack its generator beside the SVS models."""
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        prepare_voc_features,
    )
    from ensemble_svs_with_interactions_tpu_torch.train import vocoder_trainer

    voc = cfg.get("vocoder", None)
    if not voc:
        logger.info("stage 10: no cfg.vocoder section, skipping")
        return
    voc = dict(voc)
    if voc.get("model_config") and not voc.get("model"):
        raise FileNotFoundError(
            f"vocoder.model_config not found: {voc['model_config']}"
        )

    ac_params = dict(cfg.features.acoustic.params)
    acoustic_cfg = _train_cfg(cfg, work, "acoustic")
    ss = list(acoustic_cfg.model.stream_sizes)
    has_dyn = list(acoustic_cfg.model.has_dynamic_features)
    nwin = int(acoustic_cfg.model.num_windows)
    static_ss = []
    for s, d in zip(ss, has_dyn):
        static_ss.append(s // nwin if d else s)

    for split in ("train_no_dev", "dev"):
        prepare_voc_features.main(
            [
                str(work / "dump" / split / "org" / "out_acoustic"),
                str(work / "vocoder" / split / "in_vocoder"),
                "--stream-sizes",
                ",".join(str(s) for s in ss),
                "--num-windows",
                str(nwin),
                "--has-dynamic-features",
                ",".join(str(int(d)) for d in has_dyn),
            ]
        )

    train_cfg = _wrap(
        {
            "seed": int(cfg.get("seed", 1234)),
            "verbose": int(cfg.get("verbose", 1)),
            "data": {
                "train_no_dev": {
                    "in_dir": str(work / "vocoder/train_no_dev/in_vocoder")
                },
                "sample_rate": int(ac_params.get("sample_rate", 48000)),
                "frame_period": float(ac_params.get("frame_period", 5)),
                "stream_sizes": static_ss,
                **dict(voc.get("data", {}) or {}),
            },
            "model": dict(voc["model"]),
            "train": {
                "out_dir": str(work / "exp" / "vocoder"),
                **dict(voc.get("train", {}) or {}),
            },
        }
    )
    if train_cfg.train.out_dir is None:
        # a packaged vocoder config's placeholder (``out_dir: null``,
        # lifted by _materialize_packaged_configs) means the runner's
        # directory; the JAX runner hands its trainer the null
        train_cfg.train.out_dir = str(work / "exp" / "vocoder")
    vocoder_trainer.train_vocoder(train_cfg, device=_device(cfg))
    # the generator packed so that SPSVS loads it (svs.load_vocoder) and
    # vocoder_type="auto" resolves to the neural vocoder
    vocoder_trainer.pack_vocoder(train_cfg, work / "exp" / "vocoder",
                                 work / "packed_model")
    logger.info(
        "stage 10: vocoder trained at %s and packed", work / "exp" / "vocoder"
    )


def stage11_evaluate_timing(cfg, work):
    """Dump predicted timelag/duration arrays for objective timing eval,
    then write ``QUALITY.json``."""
    ev = cfg.get("timing_eval", None)
    score_dir = (ev or {}).get("score_label_dir") or cfg.get_path(
        "synthesis.label_dir"
    )
    if not score_dir:
        raise ValueError(
            "stage 11 needs timing_eval.score_label_dir (or "
            "synthesis.label_dir) in the recipe config"
        )
    align_dir = (ev or {}).get("align_label_dir") or score_dir
    out_dir = work / "timing_eval"
    argv = [
        str(work / "packed_model"), str(score_dir), str(align_dir),
        str(out_dir), "--device", _device(cfg),
    ]
    if cfg.get("multitrack", False):
        from ensemble_svs_with_interactions_tpu_torch.bin import (
            evaluate_timing_multitrack,
        )

        spk_names = cfg.get("spk_list", None)
        if spk_names:
            argv += ["--spk-names", ",".join(spk_names)]
        evaluate_timing_multitrack.main(argv)
    else:
        from ensemble_svs_with_interactions_tpu_torch.bin import (
            evaluate_timing,
        )

        evaluate_timing.main(argv)
    logger.info("stage 11: timing dumps at %s", out_dir)
    _write_quality_json(cfg, work)


def _write_quality_json(cfg, work):
    """Aggregate each phase's end-of-training dev metrics into
    ``<work>/QUALITY.json`` (MGC-MCD / BAP-MCD / VUV% / F0-RMSE of the
    acoustic phase's dev pass, each phase's losses)."""
    quality = {}
    for phase in ("timelag", "duration", "acoustic"):
        p = work / "exp" / phase / "dev_metrics.json"
        if p.exists():
            quality[phase] = json.loads(p.read_text())
    if not quality:
        logger.warning("stage 11: no dev_metrics.json found under %s",
                       work / "exp")
        return
    out = work / "QUALITY.json"
    out.write_text(json.dumps(quality, indent=1))
    ac = quality.get("acoustic", {}).get("best", {})
    logger.info(
        "stage 11: QUALITY.json at %s (acoustic best: %s)",
        out,
        {k: round(v, 4) for k, v in ac.items() if k.startswith("ObjEval")},
    )


STAGES = {
    -1: stage_m1_data_prep,
    0: stage0_utt_lists,
    1: stage1_features,
    2: stage2_scalers,
    3: stage3_train_timelag,
    4: stage4_train_duration,
    5: stage5_train_acoustic,
    6: stage6_pack,
    7: stage7_synthesis,
    8: stage8_postfilter_features,
    9: stage9_train_postfilter,
    10: stage10_train_vocoder,
    11: stage11_evaluate_timing,
}


def _materialize_packaged_configs(cfg, recipe_dir: Path):
    """Resolve recipe-relative model-config references.

    Packaged recipes (``ensemble_svs_with_interactions_tpu/recipes/*/
    config.yaml``) point at the package's model YAMLs with paths relative
    to the recipe file — the same conf/ indirection the reference
    recipes use (reference config.yaml ``timelag_model``/``acoustic_model``
    names resolved under the recipe dir).  ``postfilter.model_config`` /
    ``vocoder.model_config`` paths are loaded here and expanded into the
    inline sections the stages consume (the recipe's own ``train``/``data``
    keys override the loaded defaults)."""

    def resolve(p):
        path = Path(p)
        if not path.is_absolute() and not path.exists():
            cand = recipe_dir / path
            if cand.exists():
                return str(cand)
        return str(path)

    if cfg.get("question_path", None):
        cfg["question_path"] = resolve(cfg["question_path"])
    for section in ("timelag", "duration", "acoustic", "postfilter", "vocoder"):
        sec = cfg.get(section, None)
        if sec and sec.get("model_config"):
            sec["model_config"] = resolve(sec["model_config"])
    # postfilter/vocoder stages are opt-in (--stop-stage >= 8): expand
    # their model_config references lazily so a recipe that stops at
    # stage 7 never needs those files present
    pf = cfg.get("postfilter", None)
    if pf and pf.get("model_config") and not pf.get("model"):
        if Path(pf["model_config"]).exists():
            loaded = load_config(pf["model_config"])
            pf["model"] = Config(
                {k: loaded[k] for k in ("netG", "netD") if k in loaded}
            )
    voc = cfg.get("vocoder", None)
    if voc and voc.get("model_config"):
        if Path(voc["model_config"]).exists():
            loaded = load_config(voc["model_config"])
            # packaged vocoder YAMLs are full train_vocoder configs: lift
            # their model/train/data as section defaults. Stage 10 owns
            # the split dirs (it computes them under the work dir), so a
            # standalone config's placeholder train_no_dev must not
            # clobber them.
            for key in ("model", "train", "data"):
                if key in loaded:
                    defaults = Config(dict(loaded[key]))
                    if key == "data":
                        defaults.pop("train_no_dev", None)
                        defaults.pop("dev", None)
                    voc[key] = merge(defaults, voc.get(key, {}) or {})
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--stop-stage", type=int, default=7)  # 8-10 opt-in
    ap.add_argument("overrides", nargs="*")
    # intermixed: key=value overrides may follow the options (a plain
    # parse_args of Python before 3.12.7 takes the empty list at the
    # config and then refuses them)
    args = ap.parse_intermixed_args(argv)

    cfg = load_config(args.config)
    if args.overrides:
        cfg = merge(cfg, parse_overrides(args.overrides))
    cfg = _materialize_packaged_configs(
        cfg, Path(args.config).parent.resolve()
    )
    _refuse_multitrack(cfg, args.stage, args.stop_stage)
    work = Path(cfg.work_dir)
    work.mkdir(parents=True, exist_ok=True)

    for stage in range(args.stage, args.stop_stage + 1):
        if stage in STAGES:
            logger.info("=== stage %d ===", stage)
            STAGES[stage](cfg, work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
