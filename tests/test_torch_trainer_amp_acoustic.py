"""The acoustic trainers' bf16 AMP arm, as the recipe trains its acoustic
phase (``use_amp: true``), against the JAX package's on the CPU.

The recipe's acoustic phase on the tiny flagship through
``train_multitrack_model`` (as in ``test_torch_trainer_multitrack.py``),
and the single-track voice's acoustic model through ``train_model`` (as
in ``test_torch_trainer.py``), each with ``use_amp`` on both sides from
one JAX start checkpoint, 3 epochs, held by ``metrics.jsonl``
(``test_torch_trainer_amp.assert_metrics_follow``): each epoch's mean
gradient norm within ACOUSTIC_GRADNORM_RTOL of JAX's, and each loss
within 2e-2 of JAX's (the single-track voice, as the timing models) or
within MULTITRACK_LOSS_RTOL (the multitrack phase).

The bounds are wider than the timing models' because in bf16 the
gradients of the lf0 encoder's conv layers, in front of training-mode
batch norms, are dominated by rounding, and the frameworks round
differently: one AMP step of the multitrack run's first batch gives the
first conv's weight a gradient norm of 0.1848 in the port, 0.2187 in JAX
and 0.2310 in float32, and the whole gradient 0.4495 / 0.4971 / 0.4629.
Over the run the port's training-split epoch means lie 13-17% below its
float32 gradient norm where JAX's lie within 9%, so the two differ by up
to 19.9%, and the port's training-split LogF0 interaction loss lies
1.7-2.8% above float32 where JAX's lies 0.3-0.5% below (up to 3.3%
apart); its total loss up to 1.6% from JAX's, the feature loss and every
dev metric within 1.3%.  The single-track run differs by up to 5.7% in
the gradient norm and 0.02% in the losses.  A zero or halved gradient
still fails.
"""

from tests.test_torch_trainer import jax_start as single_start
from tests.test_torch_trainer import run as run_single
from tests.test_torch_trainer import single_config
from tests.test_torch_trainer_amp import (  # noqa: F401  (corpus: a fixture)
    _runs,
    assert_metrics_follow,
    corpus,
    metrics,
)
from tests.test_torch_trainer_multitrack import jax_start as mt_start
from tests.test_torch_trainer_multitrack import (
    ACOUSTIC_DATA,
    acoustic_model,
    phase_config,
    run_jax,
    run_port,
)

ACOUSTIC_GRADNORM_RTOL = 0.25
MULTITRACK_LOSS_RTOL = 5e-2


def test_multitrack_acoustic_trainer_amp_follows_jax(corpus, tmp_path):
    """The recipe's acoustic phase in AMP on the tiny flagship (dropout
    0, the interaction losses and the pitch regularization on)."""
    cfg = phase_config("acoustic", corpus, tmp_path, acoustic_model(),
                       **{**ACOUSTIC_DATA, "train.logf0_diff_weight": 1.0,
                          "train.mgc_diff_weight": 1.0})
    start = mt_start(cfg, True, tmp_path / "start")
    dirs = _runs(cfg, start, lambda side, c: (
        run_jax if side == "jax" else run_port)(c, True), f32=False)
    assert_metrics_follow(metrics(dirs["port_amp"]), metrics(dirs["jax_amp"]),
                          MULTITRACK_LOSS_RTOL, ACOUSTIC_GRADNORM_RTOL)


def test_single_track_acoustic_trainer_amp_follows_jax(corpus, tmp_path):
    """The single-track voice's acoustic model in AMP through
    ``train_model``."""
    cfg = single_config(corpus, tmp_path)
    start = single_start(cfg, tmp_path / "start")
    dirs = _runs(cfg, start, run_single, f32=False)
    assert_metrics_follow(metrics(dirs["port_amp"]), metrics(dirs["jax_amp"]),
                          grad_rtol=ACOUSTIC_GRADNORM_RTOL)
