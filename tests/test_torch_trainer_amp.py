"""The trainers' bf16 AMP arm, as the recipe trains (``use_amp: true``),
against the JAX package's on the CPU.

The runs of ``test_torch_trainer_multitrack.py`` and
``test_torch_trainer.py`` with ``use_amp`` on both sides, from the same
start checkpoint, and the port's float32 run beside them.  Criteria, set
from bf16's 8-bit mantissa (relative rounding 2**-9, compounded over a
few layers and over the run's steps):

* each loss of ``metrics.jsonl`` within 2e-2 of JAX's and each epoch's
  gradient norm within 5e-2 (``chip_smoke.AMP_GRAD_RTOL``);
* for one run of each trainer on a timing model (the multitrack
  trainer's duration phase, the single-track trainer's duration model),
  each parameter's update over the run (final - start) by
  ``chip_smoke.judge_amp`` against the JAX run's, with the port's float32
  run as the oracle: within 5e-2 of its scale, or, where two bf16 runs
  differ by more, a cosine of 0.9 or more with JAX's, an L2 distance at
  most 0.45 of its norm and no farther from float32 than 3 times JAX's.
  A zero, inverted or halved update fails these.

The acoustic models' AMP runs are held by their ``metrics.jsonl`` in
``test_torch_trainer_amp_acoustic.py``, not per tensor: their conv biases
in front of each batch norm have no gradient in exact arithmetic, and in
bf16 the port's eager ops (each output rounded to bf16) give them updates
above ``judge_amp``'s floor where XLA's fused CPU kernels give almost
none, and over a run of steps the tiny decoders' narrow layers drift
apart from JAX's as far as JAX's own drift from float32.  One AMP step of
the acoustic model is held per tensor in ``test_torch_train_amp.py``, and
the trainer's AMP acoustic phase runs at full width on the card
(``chip_smoke.py`` phase ``trainer``).
"""

import json
from pathlib import Path

import pytest
import torch

import chip_smoke
from tests.test_torch_trainer import jax_start as single_start
from tests.test_torch_trainer import run as run_single
from tests.test_torch_trainer_multitrack import jax_start as mt_start
from tests.test_torch_trainer_multitrack import (
    NEPOCHS,
    SGD,
    TIMING_DATA,
    TIMING_DIM,
    params,
    phase_config,
    run_jax,
    run_port,
    timing_model,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import merge
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

LOSS_RTOL = 2e-2
GRAD_RTOL = chip_smoke.AMP_GRAD_RTOL
COS_MIN = 0.9
L2_MAX = 0.45


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return chip_smoke.write_corpus(tmp_path_factory.mktemp("corpus"), 2, 1,
                                   (40, 64), seed=5, timing_dim=TIMING_DIM)


def metrics(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def updates(run_dir, start):
    p0 = params(start)
    return {k: torch.from_numpy(v - p0[k])
            for k, v in params(run_dir / "latest.ckpt").items()}


def assert_metrics_follow(got, ref, loss_rtol=LOSS_RTOL,
                          grad_rtol=GRAD_RTOL):
    assert len(got) == len(ref) == 2 * NEPOCHS
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k, v in r.items():
            rtol = grad_rtol if k.endswith("GradNorm") else loss_rtol
            assert abs(g[k] - v) <= rtol * abs(v) + 1e-9, (r["step"], k,
                                                           g[k], v)


def assert_amp_follows(jax_amp, port_amp, port_f32, start):
    assert_metrics_follow(metrics(port_amp), metrics(jax_amp))
    summary = chip_smoke.amp_summary(chip_smoke.judge_amp(
        updates(port_amp, start), updates(jax_amp, start),
        updates(port_f32, start), GRAD_RTOL, COS_MIN, L2_MAX))
    assert not summary["failed"], summary["failed"]


def _runs(cfg, start, run, f32=True):
    """{jax_amp, port_amp[, port (float32)]}: run directories."""
    root = Path(cfg["train"]["out_dir"])
    dirs = {}
    for name, side, use_amp in (("jax_amp", "jax", True),
                                ("port_amp", "port", True),
                                ("port", "port", False))[:3 if f32 else 2]:
        dirs[name] = root / name
        run(side, merge(cfg, {"train": {
            "out_dir": str(dirs[name]), "use_amp": use_amp,
            "resume": {"checkpoint": str(start)}}}))
    return dirs


def test_multitrack_trainer_amp_follows_jax(corpus, tmp_path):
    """The recipe's duration phase in AMP."""
    cfg = phase_config("duration", corpus, tmp_path, timing_model("duration"),
                       **TIMING_DATA)
    start = mt_start(cfg, False, tmp_path / "start")
    dirs = _runs(cfg, start, lambda side, c: (
        run_jax if side == "jax" else run_port)(c, False))
    assert_amp_follows(dirs["jax_amp"], dirs["port_amp"], dirs["port"],
                       start)


def test_single_track_trainer_amp_follows_jax(corpus, tmp_path):
    """The single-track voice's duration model (``duration_vp_mdn.yaml``
    at width 8, dropout 0) in AMP, through ``train_model``."""
    model = chip_smoke.shipped_config("duration/duration_vp_mdn.yaml")
    model["netG"].update(in_dim=TIMING_DIM, hidden_dim=8, num_layers=2,
                         dropout=0.0)
    cfg = merge(chip_smoke.recipe_phase_config(
        "duration", corpus, tmp_path, multitrack=False,
        **{**SGD, **TIMING_DATA}), {"model": model})
    start = single_start(cfg, tmp_path / "start")
    dirs = _runs(cfg, start, lambda side, c: run_single(side, c, False))
    assert_amp_follows(dirs["jax_amp"], dirs["port_amp"], dirs["port"],
                       start)

