"""The acoustic trainers' bf16 AMP arm, as the recipe trains its acoustic
phase (``use_amp: true``), against the JAX package's on the CPU.

The recipe's acoustic phase on the tiny flagship through
``train_multitrack_model`` (as in ``test_torch_trainer_multitrack.py``),
and the single-track voice's acoustic model through ``train_model`` (as
in ``test_torch_trainer.py``), each with ``use_amp`` on both sides from
one JAX start checkpoint, NEPOCHS epochs, held by ``metrics.jsonl``
(``test_torch_trainer_amp.assert_metrics_follow``): each epoch's mean
gradient norm and each loss against JAX's.

The multitrack phase holds its gradient norm within
MULTITRACK_GRADNORM_RTOL of JAX's and every loss within
MULTITRACK_LOSS_RTOL: readings 3.3% and 2.6% (the training split's LogF0
interaction loss; every other loss within 1.3%).  The port's epoch means
lie within 7.3% of its float32 gradient norm, JAX's within 9.4%.  The
AR decoder's residual log-F0 is summed with the denormalized score log-F0
in float32 (``models/tacotron.lf0_residual``), as JAX's NumPy float64
ratio makes it: summed in bf16, which steps by 0.03 at a log-F0 of 6, the
gradient norm lies 13-17% under float32 and 19.9% from JAX's
(``tools/amp_divergence.py`` holds the steps one by one from JAX's
states).  The JAX side runs its
LSTMs on the masked scan, the CPU's path, which returns float32 where the
port returns bf16 as JAX's device training path does (``tests/
test_torch_train_amp.py::test_amp_dtype_flow_differs_from_jax_scan``);
against that path (``tests/test_torch_train_amp.jax_device_lstm``) the
readings are 11.4% and 1.6%.  The single-track run's gradient-norm bound
is ACOUSTIC_GRADNORM_RTOL (its losses within 2e-2, as the timing
models'): in bf16 the gradients of the lf0 encoder's conv layers, in front
of training-mode batch norms, are dominated by rounding, and the
frameworks round differently (reading 5.6% in the gradient norm, 0.4% in
the pitch loss, every other loss within 0.02%).  A zero or halved gradient
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
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ACOUSTIC_GRADNORM_RTOL = 0.25
MULTITRACK_GRADNORM_RTOL = 0.1
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
                          MULTITRACK_LOSS_RTOL, MULTITRACK_GRADNORM_RTOL)


def test_single_track_acoustic_trainer_amp_follows_jax(corpus, tmp_path):
    """The single-track voice's acoustic model in AMP through
    ``train_model``."""
    cfg = single_config(corpus, tmp_path)
    start = single_start(cfg, tmp_path / "start")
    dirs = _runs(cfg, start, run_single, f32=False)
    assert_metrics_follow(metrics(dirs["port_amp"]), metrics(dirs["jax_amp"]),
                          grad_rtol=ACOUSTIC_GRADNORM_RTOL)
