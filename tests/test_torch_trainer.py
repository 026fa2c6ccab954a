"""The port's single-track trainer and its parts against the JAX
package's on the CPU: ``train/metrics.py``, the pitch regularization's
weights, ``create_train_step`` for one step and ``train_model`` over 3
epochs.

``train_model`` runs as ``test_torch_trainer_multitrack.py`` runs the
multitrack trainer (same corpus writer, recipe configs, SGD with StepLR,
shared JAX start checkpoint and float32 criteria): here on the
single-track voice's classes (``MultistreamSeparateF0ParametricModel``
with the AR residual-F0 decoder and FFConvLSTM decoders, narrow widths,
one-layer LSTMs, dropout 0), reading the corpus's acoustic dumps as
single-singer utterances, with random crops, l1, the pitch regularization
and a dev pass with distortions.  The AMP arm is judged as there.

Tolerances: one step's metrics at 1e-5 relative and its gradients
(clipping off) within 1e-5 of each gradient's scale (its largest entry, or
1e-4 of the largest entry of any gradient), except where the same step in
float64 gives a gradient under 1e-6 of the largest (zero in exact
arithmetic: the biases in front of batch norms), where both sides must
stay under that too; the metrics at 1e-6 relative; the weights bitwise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import losses as jax_losses
from ensemble_svs_with_interactions_tpu.train import metrics as jax_metrics
from ensemble_svs_with_interactions_tpu.train import trainer as jax_trainer
from ensemble_svs_with_interactions_tpu.parallel import make_mesh
from ensemble_svs_with_interactions_tpu.utils.config import _wrap
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu.utils.scalers import (
    StandardScaler as JaxStandardScaler,
)
from ensemble_svs_with_interactions_tpu_torch.train import loop
from ensemble_svs_with_interactions_tpu_torch.train import losses
from ensemble_svs_with_interactions_tpu_torch.train import metrics
from ensemble_svs_with_interactions_tpu_torch.train import (
    trainer as port_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    merge,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_trainer_multitrack import (
    ACOUSTIC_DATA,
    NEPOCHS,
    SGD,
    assert_trainers_agree,
    init_single,
    traced_init,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

STEP_RTOL = 1e-5
GRAD_FLOOR = 1e-4
VANISH = 1e-6
METRIC_RTOL = 1e-6
SS = [60, 1, 1, 5]


def single_acoustic_model():
    """The single-track voice's acoustic model at narrow widths
    (``chip_smoke.single_phases(tiny=True)``), one-layer LSTMs, the
    decoders' feed-forward layers 32 wide, dropout and prenet dropout 0."""
    _, phases = chip_smoke.single_phases(tiny=True)
    cfg = phases["acoustic"][0]
    net = cfg["netG"]
    for k in ("mgc_model", "vuv_model", "bap_model"):
        net[k].update(num_lstm_layers=1, ff_hidden_dim=32, dropout=0.0)
    net["encoder"]["num_layers"] = 1
    net["lf0_model"].update(num_lstm_layers=1, prenet_dropout=0.0)
    return cfg


# ------------------------------------------------------------------ metrics
def _streams(seed, B=3, T=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, sum(SS))).astype(np.float32)
    x[..., 60] = rng.normal(0.2, 0.3, (B, T))
    x[..., 61] = rng.uniform(size=(B, T)) > 0.3
    return x


def test_metrics_match_jax():
    """melcd, vuv_error, lf0_mean_squared_error and compute_distortions on
    a padded batch through the flagship's out scaler."""
    pred, target = _streams(0), _streams(1)
    lengths = np.array([40, 31, 17])
    _, phases = chip_smoke.flagship_phases()
    sc = phases["acoustic"][2]
    jsc = JaxStandardScaler(sc.mean_, sc.var_, sc.scale_)
    for fn in ("melcd", "vuv_error", "mean_squared_error"):
        np.testing.assert_allclose(
            getattr(metrics, fn)(pred, target, lengths),
            getattr(jax_metrics, fn)(pred, target, lengths),
            rtol=METRIC_RTOL)
    args = (target[..., 60:61], target[..., 61:62], pred[..., 60:61],
            pred[..., 61:62], lengths)
    for linear in (False, True):
        np.testing.assert_allclose(
            metrics.lf0_mean_squared_error(*args, linear_domain=linear),
            jax_metrics.lf0_mean_squared_error(*args, linear_domain=linear),
            rtol=METRIC_RTOL)
    got = metrics.compute_distortions(torch.from_numpy(pred), target,
                                      lengths, sc, SS, [False] * 4, 1)
    ref = jax_metrics.compute_distortions(pred, target, lengths, jsc, SS,
                                          [False] * 4, 1)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, err_msg=k)


def test_pitch_regularization_weight_is_bitwise_jax():
    """Notes of 3-80 frames with rests and padding (zeros), decay sizes
    around the note lengths."""
    rng = np.random.default_rng(2)
    lf0 = np.zeros((4, 300), np.float32)
    for b in range(4):
        t = 0
        while t < 260:
            n = int(rng.integers(3, 80))
            if rng.uniform() > 0.2:
                lf0[b, t:t + n] = rng.uniform(5.0, 6.5)
            t += n
    for decay in (5, 25, 60):
        got = losses.compute_pitch_regularization_weight(lf0, decay)
        ref = jax_losses.compute_pitch_regularization_weight(lf0, decay)
        assert got.dtype == ref.dtype and got.shape == (4, 300, 1)
        np.testing.assert_array_equal(got, ref)
        if decay == 5:  # notes of 11 frames or more carry weight
            assert got.max() == 0.5 and (got > 0).mean() > 0.2


# --------------------------------------------------------------- train step
def _timing_model():
    cfg = chip_smoke.shipped_config("duration/duration_vp_mdn.yaml")
    cfg["netG"].update(hidden_dim=8, num_layers=2, dropout=0.0)
    return cfg


STEP_CASES = {
    # (model config function, step options)
    "acoustic": (single_acoustic_model, dict(feats_criterion="l1",
                                             pitch_reg_weight=1.0)),
    "acoustic_stream_wise": (single_acoustic_model, dict(
        stream_wise_loss=True, stream_weights=[0.5, 0.2, 0.2, 0.1],
        pitch_reg_weight=0.0)),
    "duration_mdn": (_timing_model, dict(pitch_reg_weight=0.0)),
}


def _step_batch(cfg, seed=0, B=3, T=40):
    net = cfg["netG"]
    rng = np.random.default_rng(seed)
    out_dim = sum(cfg["stream_sizes"])
    batch = {"in_feats": rng.uniform(0, 1, (B, T, net["in_dim"])).astype(
                 np.float32),
             "out_feats": rng.normal(size=(B, T, out_dim)).astype(np.float32),
             "lengths": np.array([T, T - 9, T - 17], np.int32)}
    if out_dim == sum(SS):
        batch["out_feats"][..., 61] = rng.uniform(size=(B, T)) > 0.3
        lf0 = np.repeat(rng.uniform(5.0, 6.5, (B, T // 8)), 8, axis=1)
        batch["pitch_reg_dyn_ws"] = (
            losses.compute_pitch_regularization_weight(lf0, 3))
    return batch


def _capture_grads():
    """An optax transformation that leaves the parameters alone and keeps
    the gradient it was given as its state, so the JAX step hands back
    its gradients exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_create_train_step_matches_jax(case):
    """One step of the single-track step (clipping off): the metrics, every
    gradient and the new running statistics; and the evaluation before
    it."""
    build, kw = STEP_CASES[case]
    assert_step_matches_jax(build(), kw)


def assert_step_matches_jax(cfg, kw, batch=None, variables=None):
    """``create_train_step``'s evaluation and one step (clipping off) of
    the model config ``cfg`` with the step options ``kw`` against JAX's on
    ``batch`` (``_step_batch(cfg)`` by default), judged as the module's
    docstring says.  Both start from flax ``variables``, by default the
    JAX trainer's initial ones (a model whose JAX ``init`` takes long to
    compile passes the port's, ``torch_to_flax`` of its flax-scheme
    draw)."""
    batch = _step_batch(cfg) if batch is None else batch
    jm = jax_instantiate(cfg["netG"])
    if variables is None:
        variables = init_single(jm, _wrap({"model": cfg}))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    tx = _capture_grads()
    jstep, jeval = jax_loop.create_train_step(
        jm, tx, cfg, clip_norm=1e9, donate=False, **kw)
    state = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {}),
             "opt_state": tx.init(variables["params"]),
             "step": jnp.asarray(0)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_eval, _ = jeval(state, jbatch)
    new_state, ref = jstep(state, jbatch, jax.random.PRNGKey(0))

    def port_step(dtype):
        module = flax_to_torch(instantiate(cfg["netG"]), variables).to(dtype)
        opt, sched = loop.build_optimizer(
            module.parameters(), {"name": "SGD", "params": {"lr": 0.0}})
        step, eval_step = loop.create_train_step(
            module, opt, cfg, scheduler=sched, clip_norm=1e9, device="cpu",
            **kw)
        evaluated, _ = eval_step(batch)
        got = step(batch, torch.Generator().manual_seed(0))
        return module, got, evaluated

    module, got, got_eval = port_step(torch.float32)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], float(v), rtol=STEP_RTOL,
                                   atol=1e-7, err_msg=k)
    for k, v in ref_eval.items():
        np.testing.assert_allclose(got_eval[k], float(v), rtol=STEP_RTOL,
                                   atol=1e-7, err_msg=k)
    if kw["pitch_reg_weight"]:
        assert got["Loss_Pitch"] > 0
    stats = new_state["batch_stats"]
    ref_module = flax_to_torch(instantiate(cfg["netG"]), {
        "params": new_state["opt_state"],
        **({"batch_stats": stats} if stats else {})})
    ref_grads = {k: p.detach() for k, p in ref_module.named_parameters()}
    oracle = {k: p.grad for k, p in port_step(torch.float64)[0]
              .named_parameters()}
    largest = max(g.abs().max().item() for g in oracle.values())
    for k, p in module.named_parameters():
        g = ref_grads[k]
        if oracle[k].abs().max().item() < VANISH * largest:
            # zero in exact arithmetic (a bias in front of a batch norm):
            # both sides hold only rounding noise
            assert max(p.grad.abs().max().item(), g.abs().max().item()) \
                < VANISH * largest, k
            continue
        err = (p.grad - g).abs().max().item()
        scale = max(g.abs().max().item(), GRAD_FLOOR * largest)
        assert err <= STEP_RTOL * scale, (k, err, scale)
    for k, v in ref_module.named_buffers():
        np.testing.assert_allclose(dict(module.named_buffers())[k].numpy(),
                                   v.numpy(), atol=STEP_RTOL, err_msg=k)


# ------------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return chip_smoke.write_corpus(tmp_path_factory.mktemp("corpus"), 2, 1,
                                   (40, 64), seed=6, timing_dim=4)


def run_jax(cfg, acoustic=True):
    """The JAX trainer on one CPU device, its initializer traced
    (``traced_init``: every run here resumes from a start checkpoint)."""
    assert cfg["train"]["resume"]["checkpoint"]
    orig = jax_trainer.make_mesh, jax_trainer._init_variables
    jax_trainer.make_mesh = lambda: make_mesh(1)
    jax_trainer._init_variables = traced_init(jax_trainer._init_variables)
    try:
        jax_trainer.train_model(_wrap(dict(cfg)), is_acoustic=acoustic)
    finally:
        jax_trainer.make_mesh, jax_trainer._init_variables = orig


def run_port(cfg, acoustic=True):
    """The port's trainer on the CPU."""
    port_trainer.train_model(cfg, is_acoustic=acoustic, device="cpu")


def single_config(corpus, out_dir):
    """The recipe's acoustic phase on the single-track voice's classes, in
    float32."""
    cfg = chip_smoke.recipe_phase_config(
        "acoustic", corpus, out_dir, multitrack=False,
        **{**SGD, **ACOUSTIC_DATA, "train.use_amp": False})
    return merge(cfg, {"model": single_acoustic_model()})


def jax_start(cfg, path):
    """The JAX trainer's initial variables (``_init_variables``), saved by
    its save_checkpoint; returns the checkpoint's path."""
    jm = jax_instantiate(cfg["model"]["netG"])
    v = init_single(jm, _wrap(dict(cfg)))
    jax_loop.save_checkpoint(path, jax_loop.TrainState(
        v["params"], v.get("batch_stats", {}), {}, 0), 0)
    return path / "latest.ckpt"


def run(side, cfg, acoustic=True):
    """One side's run of ``cfg``: "jax" or "port"."""
    return {"jax": run_jax, "port": run_port}[side](cfg, acoustic)


def test_train_model_matches_jax(corpus, tmp_path):
    """The single-track voice's acoustic trainer: random crops, l1, the
    pitch regularization, a dev pass with distortions."""
    cfg = single_config(corpus, tmp_path)
    start = jax_start(cfg, tmp_path / "start")
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        run(side, merge(cfg, {"train": {
            "out_dir": str(dirs[side]),
            "resume": {"checkpoint": str(start)}}}))
    assert_trainers_agree(dirs)
    lines = [json.loads(line) for line in
             (dirs["port"] / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2 * NEPOCHS
    assert lines[0]["train_no_dev/Loss_Pitch"] > 0
    assert "dev/ObjEval_MGC_MCD" in lines[1]
