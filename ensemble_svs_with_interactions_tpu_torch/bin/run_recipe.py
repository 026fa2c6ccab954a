"""Staged recipe runner, the data stages: corpus -> lists -> features ->
scalers, driven by one YAML config; the port's copy of stages -1 to 2 of
``ensemble_svs_with_interactions_tpu/bin/run_recipe.py``.

  -1 corpus data preparation (jaCappella-style multitrack segmentation,
     song-level splits; cfg.data_prep section)
  0  split utterance lists (train_no_dev / dev / eval); when
     cfg.data.lists_dir is set (e.g. written by stage -1), the song-level
     lists are copied instead of re-split
  1  feature extraction (prepare_features; multitrack adds note times)
  2  fit scalers + normalize features

Stages 3 to 11 (training, packing, synthesis, the postfilter, the
vocoder, timing evaluation) are not wired into this runner yet: a range
that reaches one raises ``NotImplementedError`` before any stage runs,
where the JAX runner would skip a stage it does not know.  So
``--stop-stage`` defaults to 2, the last wired stage, where the JAX
runner's defaults to 7.  The trainers
(``bin/train_*.py``) and the vocoder's stage 10 (``bin/train_vocoder.py``,
``train/vocoder_trainer.pack_vocoder``) run on their own.

The recipe file is read with the port's YAML subset (``utils/yaml_io``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.run_recipe
       recipe.yaml [--stage N] [--stop-stage M] [key=value ...]
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    load_config,
    merge,
    parse_overrides,
)
from ensemble_svs_with_interactions_tpu_torch.utils.logger import getLogger

logger = getLogger(verbose=1, name="recipe")

UNWIRED = ("stage {} is not wired into the port's recipe runner yet "
           "(ROADMAP Queue 1, the recipe end to end: stages 3-7, 10 and "
           "11); run stages -1 to 2 here and the trainers' CLIs on their "
           "dumps")


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


STAGES = {
    -1: stage_m1_data_prep,
    0: stage0_utt_lists,
    1: stage1_features,
    2: stage2_scalers,
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
    ap.add_argument("--stop-stage", type=int, default=2)
    ap.add_argument("overrides", nargs="*")
    # intermixed: key=value overrides may follow the options (a plain
    # parse_args of Python before 3.12.7 takes the empty list at the
    # config and then refuses them)
    args = ap.parse_intermixed_args(argv)

    unwired = [s for s in range(args.stage, args.stop_stage + 1)
               if 3 <= s <= 11]
    if unwired:
        raise NotImplementedError(UNWIRED.format(unwired[0]))
    cfg = load_config(args.config)
    if args.overrides:
        cfg = merge(cfg, parse_overrides(args.overrides))
    cfg = _materialize_packaged_configs(
        cfg, Path(args.config).parent.resolve()
    )
    work = Path(cfg.work_dir)
    work.mkdir(parents=True, exist_ok=True)

    for stage in range(args.stage, args.stop_stage + 1):
        if stage in STAGES:
            logger.info("=== stage %d ===", stage)
            STAGES[stage](cfg, work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
