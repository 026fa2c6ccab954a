"""The port's single-track trainer and GAN trainers on 2 gloo ranks on the
CPU.  ``train_model`` against the JAX trainer with ``make_mesh`` patched
to ``make_mesh(2)`` (the single-track voice's acoustic phase: random
crops, l1, the pitch regularization, a dev pass with distortions), 2
epochs, by ``tests/test_torch_trainer_multitrack.assert_trainers_agree``
(metrics and final parameters at 1e-4); only rank 0 writes.  The
postfilter and vocoder trainers (``tests/test_torch_postfilter_train.py``'s
and ``tests/test_torch_vocoder_train.py``'s tiny configs) against the
port's own one-process run: every logged loss within GAN_RTOL and
gradient norm within GAN_GRAD_RTOL (relative), every parameter of the
checkpointed generator within GAN_ATOL.  The ranks are
``tests/torch_parallel_worker.py`` subprocesses (``tests/
test_torch_parallel_train.both_trainers``).
"""

import json
from pathlib import Path

import numpy as np
import pytest

import chip_smoke

from ensemble_svs_with_interactions_tpu.train import trainer as jax_trainer
from tests import test_torch_trainer as single
from tests.test_torch_parallel_train import (  # noqa: F401  (fixture)
    both_trainers,
    corpus,
    run_jax_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.train import (
    postfilter_trainer,
    vocoder_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import Config
from tests import test_torch_postfilter_train as tp
from tests import test_torch_vocoder_train as tv
from tests.test_torch_parallel import WORLD, free_port, run_ranks
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

GAN_RTOL = 1e-5
# the GAN steps' gradient rule (chip_smoke.VOCODER_TRAIN_GRAD_RTOL): the
# STFT losses' float32 gradients carry more rounding than their values
GAN_GRAD_RTOL = chip_smoke.VOCODER_TRAIN_GRAD_RTOL
GAN_ATOL = 1e-6


def test_train_model_on_two_ranks_matches_jax(corpus, tmp_path):
    """The single-track voice's acoustic trainer, 2 ranks."""
    cfg = single.single_config(corpus, tmp_path)
    start = single.jax_start(cfg, tmp_path / "start")
    both_trainers(
        tmp_path, cfg, start,
        lambda c: run_jax_trainer(jax_trainer, jax_trainer.train_model,
                                  "_init_variables", c, is_acoustic=True),
        multitrack=False, acoustic=True)


def vocoder_config(in_dir, out_dir):
    """``tests/test_torch_vocoder_train.config("pwg", ...)`` as a plain
    tree (its batch of 2 crops splits over the 2 ranks)."""
    model, train = tv.FAMILIES["pwg"]
    return json.loads(json.dumps({
        "seed": 3, "verbose": 0,
        "data": {"train_no_dev": {"in_dir": str(in_dir)},
                 "sample_rate": tv.SR, "frame_period": tv.FRAME_PERIOD,
                 "stream_sizes": [2, 1, 1, 3], "crop_frames": tv.TF},
        "model": {"dense_factor": 4, "sine_amp": 0.1, "noise_amp": 0.003,
                  **model},
        "train": {"out_dir": str(out_dir), "nepochs": 1,
                  "steps_per_epoch": 3, "batch_size": tv.B,
                  "optim": {"netG": {"optimizer": tv.ADAM},
                            "netD": {"optimizer": tv.ADAM}}, **train}}))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v, np.float64)


@pytest.mark.parametrize("fn", ["postfilter", "vocoder"])
def test_gan_trainer_on_two_ranks_matches_one_process(fn, tmp_path):
    """Each GAN trainer on 2 ranks (G's noise, or the crops, the global
    batch's; the losses global; both networks' gradients summed in one
    all-reduce before clipping) against one process on the whole batch."""
    if fn == "postfilter":
        data = tmp_path / "data"
        tp.write_pairs(data, 4, seed=3)
        # a second dev pair, so no batch pads to the world size (a padded
        # batch draws G's noise at another shape than one process's)
        for d in ("in", "out"):
            (data / "dev" / d / "dev01-feats.npy").write_bytes(
                (data / "train_no_dev" / d / "train_no_dev00-feats.npy")
                .read_bytes())
        cfg = tp.config(data, tmp_path / "one")
        run = postfilter_trainer.train_postfilter
    else:
        cfg = vocoder_config(tv.write_corpus(tmp_path / "in"),
                             tmp_path / "one")
        run = vocoder_trainer.train_vocoder
    run(Config(cfg), device="cpu")
    port = free_port()
    ranks = run_ranks(tmp_path / "ranks", [{
        "kind": "trainer", "port": port, "world": WORLD, "fn": fn,
        "config": {**cfg, "train": {**cfg["train"],
                                    "out_dir": str(tmp_path / "dp")},
                   "distributed": {"coordinator": f"127.0.0.1:{port}",
                                   "num_processes": WORLD,
                                   "process_id": r}}}
        for r in range(WORLD)])
    assert ranks[0]["dev"] == ranks[1]["dev"]
    got, ref = (tv_lines(tmp_path / d / "metrics.jsonl")
                for d in ("dp", "one"))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k, v in r.items():
            rtol = GAN_GRAD_RTOL if "GradNorm" in k else GAN_RTOL
            assert abs(g[k] - v) <= rtol * abs(v) + 1e-9, (k, g[k], v)
    pg, pr = (dict(_flat(flax_msgpack.from_bytes(
        (tmp_path / d / "latest.ckpt").read_bytes())["params"]))
        for d in ("dp", "one"))
    assert sorted(pg) == sorted(pr)
    for k, v in pr.items():
        np.testing.assert_allclose(pg[k], v, rtol=0, atol=GAN_ATOL,
                                   err_msg=k)


def tv_lines(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]
