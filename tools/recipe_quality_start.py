"""The port's recipe quality on the CPU mini recipe, from its own initial
weights and from the JAX trainer's, beside the JAX e2e test's ceilings.

    JAX_PLATFORMS=cpu python tools/recipe_quality_start.py [--out DIR]

The port's ``bin/run_recipe.main`` runs stages -1 to 5 with ``device=cpu``
on the corpus and recipe of ``tests/test_torch_recipe.py`` (the packaged
recipe with ``tests/util.multitrack_mini_recipe_overrides``, the mini
model configs without aliases and with ``prenet_dropout`` 0): its
acoustic phase starts from the flax schemes' draws of the port's own
generator.  Then stage 5 again on a copy of the work directory, from the
JAX multitrack trainer's initial variables (``_init_multitrack_variables``
at seed 0, saved by the JAX package's ``save_checkpoint``, read through
``train.resume.checkpoint``).  One JSON line each: the acoustic phase's
best dev ``ObjEval_*`` values beside the ceilings of
``tests/test_recipe_multitrack_e2e.py`` (calibrated on JAX's runs, which
all start from that one JAX draw).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CEILINGS = {"ObjEval_MGC_MCD": 16.9, "ObjEval_BAP_MCD": 6.74,
            "ObjEval_VUV_ERR": 0.161, "ObjEval_F0_RMSE": 13.2}


def best(work: Path) -> dict:
    metrics = json.loads((work / "exp" / "acoustic" /
                          "dev_metrics.json").read_text())["best"]
    return {k: metrics[k] for k in CEILINGS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None,
                    help="work root (a temporary directory by default)")
    args = ap.parse_args(argv)

    import jax
    import yaml

    jax.config.update("jax_platforms", "cpu")
    from ensemble_svs_with_interactions_tpu.bin import (
        run_recipe as jax_recipe,
    )
    from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
    from ensemble_svs_with_interactions_tpu.train import (
        multitrack_trainer as jmt,
    )
    from ensemble_svs_with_interactions_tpu.utils.config import (
        instantiate,
        load_config,
        merge,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe
    from tests.test_torch_recipe import RECIPE, SPKS, SR, write_conf
    from tests.util import (
        build_synthetic_jacappella_corpus,
        multitrack_mini_recipe_overrides,
    )

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(args.out or tmp)
        root.mkdir(parents=True, exist_ok=True)
        corpus = build_synthetic_jacappella_corpus(root / "corpus",
                                                   spks=SPKS, sr=SR)
        work, conf = root / "work", root / "conf"
        write_conf(conf)
        over = multitrack_mini_recipe_overrides(corpus, work, conf,
                                                work / "data", spks=SPKS,
                                                sr=SR)
        over["device"] = "cpu"
        recipe = root / "recipe.yaml"
        recipe.write_text(yaml.safe_dump(json.loads(json.dumps(
            merge(load_config(RECIPE), over)))))
        assert run_recipe.main([str(recipe), "--stage", "-1",
                                "--stop-stage", "5"]) == 0
        rows = {"port_start": best(work)}

        start = root / "jax_start"
        start.mkdir()
        for d in ("scalers", "exp"):
            shutil.copytree(work / d, start / d)
        os.symlink(work / "dump", start / "dump")
        shutil.rmtree(start / "exp" / "acoustic")
        cfg = jax_recipe._materialize_packaged_configs(load_config(recipe),
                                                       root.resolve())
        cfg = jax_recipe._resolve_lf0_stats(
            cfg, start, jax_recipe._train_cfg(cfg, start, "acoustic"))
        module = instantiate(cfg.model.netG)
        v = jax.jit(lambda s: jmt._init_multitrack_variables(
            module, cfg, True, s))(0)
        jax_loop.save_checkpoint(start / "ckpt", jax_loop.TrainState(
            v["params"], v["batch_stats"], {}, 0), 0)
        assert run_recipe.main([
            str(recipe), "--stage", "5", "--stop-stage", "5",
            f"work_dir={start}",
            f"acoustic.train.resume.checkpoint={start / 'ckpt/latest.ckpt'}",
        ]) == 0
        rows["jax_start"] = best(start)
    for name, row in rows.items():
        print(json.dumps({"start": name, **row,
                          "under_ceilings": {k: row[k] < c for k, c in
                                             CEILINGS.items()},
                          "ceilings": CEILINGS}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
