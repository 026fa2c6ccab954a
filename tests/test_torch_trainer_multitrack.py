"""The port's multitrack trainer against the JAX package's
``train_multitrack_model`` on the CPU.

Both trainers read one seeded synthetic corpus (``chip_smoke.
write_corpus``: 3 singers, frame-level acoustic and note-level timing
dumps) through the recipe's phase configs (``chip_smoke.
recipe_phase_config``), start from one checkpoint written by the JAX
package's ``save_checkpoint`` (``train.resume.checkpoint``), and train
NEPOCHS (2) epochs.  The models are tiny: the flagship's classes at narrow widths with
one-layer LSTMs, and ``MultiTrackVariancePredictor`` at width 8; dropout
and prenet dropout 0 (masks cannot match across frameworks).  The JAX
trainer runs on one device (its mesh patched to one CPU device), so both
build the same batches, with its initializer traced, not compiled (every
parameter comes from the start checkpoint; the start's initializer is
jitted with the seed as an argument).

The optimizer is SGD with the recipe's StepLR (one epoch a step here), not
the recipe's Adam: Adam divides each gradient by its own running RMS, so
the gradients that vanish in exact arithmetic (the conv biases in front
of every batch norm) step by about the learning rate on their rounding
noise, which differs between frameworks.  Adam's update itself is held in
``test_torch_train.py``; its state's checkpoint in
``test_torch_checkpoints.py``.

Criteria, float32: every ``metrics.jsonl`` value within 1e-4 relative;
each final parameter tensor within 1e-4 of its scale (its largest entry,
or 1e-4 of the largest entry of any tensor where that is larger: biases
that start at 0 and sum a batch's signed terms); the same ``best_epoch``
and the same ``dev_metrics.json`` keys.  The acoustic phase also runs on
both sides in float64 (JAX under ``jax.enable_x64``): there the port's
metrics lie within 1e-6 relative of JAX's and each tensor within 1e-6 of
its scale, which no float32 rounding can hide a wrong or frozen update
behind.  Its float32 run carries the epochs' rounding noise in the
small biases of the encoder's first LSTM and dense layers and of the mgc
decoder's dense layers: over 3 epochs 7 of its 222 tensors missed 1e-4
of their scale against JAX's float32 run (by up to 1.94e-4), and there
the port's float32 trajectory lay 1.1-2.2e-4 of scale from the exact
(JAX float64) one, 3-10 times JAX's own float32 distance.  So a float32 tensor that
misses passes if it lies within AR_HEADROOM times JAX's distance, or
times 1e-4 of its scale, of the JAX float64 run (``judge_params``).
``test_judges_fail_a_frozen_leaf`` leaves each leaf in turn at its start
value and holds that these checks fail it.  The AMP arm's runs are in
``test_torch_trainer_amp.py`` and ``test_torch_trainer_amp_acoustic.py``.
"""

import contextlib
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.parallel import make_mesh
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import (
    multitrack_trainer as jax_trainer,
)
from ensemble_svs_with_interactions_tpu.train import (
    trainer as jax_single_trainer,
)
from ensemble_svs_with_interactions_tpu.utils.config import _wrap
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.train import (
    multitrack_trainer as port_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    merge,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

RTOL = 1e-4
F64_RTOL = 1e-6
NEPOCHS = 2
TIMING_DIM = 12
SGD = {"train.optim.optimizer.name": "SGD",
       "train.optim.optimizer.params.lr": 0.05,
       "train.optim.lr_scheduler.params.step_size": 1,
       "train.nepochs": NEPOCHS}
# 4 crops of 32 frames a batch (one static shape for JAX), the pitch
# regularization on notes over 8 frames with the score lf0's index and range
ACOUSTIC_DATA = {"data.segment_length": 32, "data.batch_max_frames": 128,
                 "train.pitch_reg_weight": 1.0,
                 "train.pitch_reg_decay_size": 4, "data.in_lf0_idx": 51,
                 "data.in_lf0_min": 4.72, "data.in_lf0_max": 6.84}
# about 4 note-merged pairs a batch
TIMING_DATA = {"data.batch_max_frames": 24}


def acoustic_model():
    """The flagship's acoustic model at narrow widths (chip_smoke.TINY;
    the decoders' feed-forward layers 32 wide, so no frame's ReLUs all
    die), one-layer LSTMs, dropout 0, 3 speakers."""
    ac, _ = chip_smoke.flagship_acoustic_config(3, tiny=True)
    net = ac["netG"]
    for k in ("mgc_model", "vuv_model", "bap_model"):
        net[k].update(num_lstm_layers=1, ff_hidden_dim=32, dropout=0.0)
    net["encoder"]["num_layers"] = 1
    net["lf0_model"].update(num_lstm_layers=1, prenet_dropout=0.0)
    return ac


def timing_model(phase):
    """The shipped timing model's class and head at width 8, 2 layers,
    dropout 0, over TIMING_DIM features a track."""
    cfg = chip_smoke.shipped_config(
        f"{phase}/multitrack_{phase}_vp_mdn.yaml")
    cfg["netG"].update(in_dim=TIMING_DIM, hidden_dim=8, num_layers=2,
                       dropout=0.0)
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return chip_smoke.write_corpus(tmp_path_factory.mktemp("corpus"), 2, 1,
                                   (40, 64), seed=5, timing_dim=TIMING_DIM)


def phase_config(phase, corpus, out_dir, model, **overrides):
    cfg = chip_smoke.recipe_phase_config(phase, corpus, out_dir,
                                         **{**SGD, **overrides})
    return merge(cfg, {"model": model})


_EAGER_INITS = (jax_trainer._init_multitrack_variables,
                jax_single_trainer._init_variables)


def init_multitrack(module, config, acoustic, seed=0):
    """The JAX multitrack trainer's ``_init_multitrack_variables``, jitted
    with the seed as an argument: the same variables from one compile per
    model, which the run's persistent compilation cache shares between
    tests and workers, instead of an eager ``init`` each time."""
    return jax.jit(lambda s: _EAGER_INITS[0](module, config, acoustic,
                                             s))(seed)


def init_single(module, config, rng_seed=0):
    """The JAX single-track trainer's ``_init_variables``, jitted so."""
    return jax.jit(lambda s: _EAGER_INITS[1](module, config, s))(rng_seed)


def traced_init(init):
    """``init`` (one of the JAX trainers' variable initialisers) traced by
    ``jax.eval_shape``, not compiled: the same tree with every parameter
    zero and the batch statistics at flax's initial values (``mean`` 0,
    ``var`` 1).  A trainer that restores every parameter from
    ``train.resume.checkpoint`` (as each run here does) trains from it as
    from ``init``'s draw."""
    def run(*args, **kw):
        shapes = jax.eval_shape(lambda: init(*args, **kw))
        return jax.tree_util.tree_map_with_path(
            lambda path, s: (jnp.ones if path[-1].key == "var"
                             else jnp.zeros)(s.shape, s.dtype), shapes)

    return run


def jax_start(cfg, acoustic, path):
    """The JAX trainer's initial variables, saved by its save_checkpoint;
    returns the checkpoint's path."""
    module = jax_instantiate(cfg["model"]["netG"])
    v = init_multitrack(module, _wrap(dict(cfg)), acoustic)
    state = jax_loop.TrainState(v["params"], v.get("batch_stats", {}),
                                optax.sgd(0.05).init(v["params"]), 0)
    jax_loop.save_checkpoint(path, state, 0)
    return path / "latest.ckpt"


def run_jax(cfg, acoustic):
    """The JAX trainer on one CPU device, its initializer traced
    (``traced_init``: every run here resumes from a start checkpoint)."""
    assert cfg.get_path("train.resume.checkpoint")
    orig = jax_trainer.make_mesh, jax_trainer._init_multitrack_variables
    jax_trainer.make_mesh = lambda: make_mesh(1)
    jax_trainer._init_multitrack_variables = traced_init(_EAGER_INITS[0])
    try:
        jax_trainer.train_multitrack_model(_wrap(dict(cfg)), acoustic)
    finally:
        jax_trainer.make_mesh, jax_trainer._init_multitrack_variables = orig


def run_port(cfg, acoustic, dtype=torch.float32):
    """The port's trainer on the CPU; ``float64`` builds every model in
    float64."""
    orig = port_trainer.instantiate
    port_trainer.instantiate = lambda node: instantiate(node).to(dtype)
    try:
        port_trainer.train_multitrack_model(cfg, acoustic, device="cpu")
    finally:
        port_trainer.instantiate = orig


@contextlib.contextmanager
def jax_float64():
    """JAX in float64, with flax's LSTM cells starting their carry in
    float64 (``initialize_carry`` draws it in the cells' float32 parameter
    type, which the JAX package's scan would then carry as float32)."""
    cell = nn.OptimizedLSTMCell
    orig = cell.initialize_carry

    def carry64(self, rng, shape):
        return jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                      orig(self, rng, shape))

    cell.initialize_carry = carry64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        cell.initialize_carry = orig


def float64_checkpoint(start, path):
    """``start`` with its float32 arrays cast to float64; returns the new
    checkpoint's path."""
    tree = flax_msgpack.from_bytes(start.read_bytes())
    path.mkdir(parents=True, exist_ok=True)
    (path / "latest.ckpt").write_bytes(flax_msgpack.to_bytes(
        jax.tree_util.tree_map(
            lambda a: (np.asarray(a, np.float64)
                       if np.asarray(a).dtype == np.float32 else a), tree)))
    return path / "latest.ckpt"


def run_both(cfg, acoustic, root, name, use_amp=False, start=None,
             float64=False):
    """{"jax", "port"[, "jax64", "port64"]: run directory} and the start
    checkpoint; ``float64`` adds both trainers' float64 runs."""
    start = start or jax_start(cfg, acoustic, root / f"{name}_start")
    runs = [("jax", run_jax, start), ("port", run_port, start)]
    if float64:
        start64 = float64_checkpoint(start, root / f"{name}_start64")

        def run_jax64(c, a):
            with jax_float64():
                run_jax(c, a)

        runs += [("jax64", run_jax64, start64),
                 ("port64", lambda c, a: run_port(c, a, torch.float64),
                  start)]
    dirs = {}
    for side, run, ckpt in runs:
        dirs[side] = root / f"{name}_{side}"
        run(merge(cfg, {"train": {"out_dir": str(dirs[side]),
                                  "use_amp": use_amp,
                                  "resume": {"checkpoint": str(ckpt)}}}),
            acoustic)
    return dirs, start


def metrics(run_dir):
    return [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


def params(path):
    tree = flax_msgpack.from_bytes(path.read_bytes())["params"]

    def flat(node, prefix=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), np.asarray(v, np.float64)

    return dict(flat(tree))


def assert_metrics_close(got, ref, rtol):
    assert len(got) == len(ref) == 2 * NEPOCHS
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k, v in r.items():
            assert abs(g[k] - v) <= rtol * abs(v) + 1e-9, (r["step"], k,
                                                           g[k], v)


def final_params(run_dir):
    return {k: torch.from_numpy(v)
            for k, v in params(run_dir / "latest.ckpt").items()}


def judge_params(got, ref, oracle=None, rtol=RTOL):
    """The tensors of ``got`` (the port's run) that fail against ``ref``
    (JAX's run in the same precision): each must lie within ``rtol`` of
    its scale (its largest entry, or ``chip_smoke.GRAD_SCALE_FLOOR`` of
    the largest entry of any tensor).  With an ``oracle`` (JAX's run in
    float64, from the same start) a float32 tensor that misses passes if
    it lies no farther from the oracle than ``chip_smoke.AR_HEADROOM``
    times JAX's own float32 distance, or than that times ``rtol`` of its
    scale where JAX happens to lie closer."""
    floor = chip_smoke.GRAD_SCALE_FLOOR * max(
        v.abs().max().item() for v in ref.values())
    bad = {}
    for k, r in ref.items():
        scale = max(r.abs().max().item(), floor)
        err = (got[k] - r).abs().max().item()
        if err <= rtol * scale:
            continue
        reading = {"rel_of_scale": err / scale}
        if oracle is not None:
            to_oracle = (got[k] - oracle[k]).abs().max().item()
            ref_to_oracle = (r - oracle[k]).abs().max().item()
            reading.update(to_oracle_of_scale=to_oracle / scale,
                           ref_to_oracle_of_scale=ref_to_oracle / scale)
            if to_oracle <= chip_smoke.AR_HEADROOM * max(ref_to_oracle,
                                                         rtol * scale):
                continue
        bad[k] = reading
    return bad


def assert_trainers_agree(dirs):
    """The float32 runs by the criteria above; with ``jax64`` and
    ``port64`` in ``dirs``, the float64 runs too, and JAX's float64 run as
    the float32 judge's oracle."""
    jax_dir, port_dir = dirs["jax"], dirs["port"]
    assert_metrics_close(metrics(port_dir), metrics(jax_dir), RTOL)
    pj, pp = final_params(jax_dir), final_params(port_dir)
    assert sorted(pj) == sorted(pp)
    oracle = None
    if "jax64" in dirs:
        assert_metrics_close(metrics(dirs["port64"]), metrics(dirs["jax64"]),
                             F64_RTOL)
        oracle = final_params(dirs["jax64"])
        bad = judge_params(final_params(dirs["port64"]), oracle,
                           rtol=F64_RTOL)
        assert not bad, bad
    bad = judge_params(pp, pj, oracle)
    assert not bad, bad
    dj = json.loads((jax_dir / "dev_metrics.json").read_text())
    dp = json.loads((port_dir / "dev_metrics.json").read_text())
    assert dp["best_epoch"] == dj["best_epoch"]
    assert sorted(dp["best"]) == sorted(dj["best"])
    assert sorted(dp["final"]) == sorted(dj["final"])
    for f in ("latest.ckpt", "best_loss.ckpt"):
        assert (port_dir / f).exists(), f


@pytest.mark.parametrize("phase", ["timelag", "duration"])
def test_timing_trainer_matches_jax(corpus, tmp_path, phase):
    """The recipe's timelag and duration phases (note-merged pairs, MDN
    heads)."""
    cfg = phase_config(phase, corpus, tmp_path, timing_model(phase),
                       **TIMING_DATA)
    dirs, _ = run_both(cfg, False, tmp_path, phase)
    assert_trainers_agree(dirs)


@pytest.fixture(scope="module")
def acoustic_runs(corpus, tmp_path_factory):
    """The recipe's acoustic phase on both sides, in float32 and float64:
    random crops of one window across both tracks, StepLR, l1, the
    interaction losses and the pitch regularization on
    (``logf0_diff_weight`` 1, ``pitch_reg_weight`` 1 with the score lf0's
    index and range, notes over 8 frames), a dev pass with distortions
    each epoch.  The run directories and the start checkpoint."""
    root = tmp_path_factory.mktemp("acoustic")
    cfg = phase_config("acoustic", corpus, root, acoustic_model(),
                       **{**ACOUSTIC_DATA, "train.logf0_diff_weight": 1.0,
                          "train.mgc_diff_weight": 1.0})
    return run_both(cfg, True, root, "acoustic", float64=True)


def test_acoustic_trainer_matches_jax(acoustic_runs):
    """The acoustic phase by every criterion above."""
    dirs, _ = acoustic_runs
    assert_trainers_agree(dirs)
    first = metrics(dirs["port"])[0]
    assert first["train_no_dev/Loss_Pitch"] > 0
    assert first["train_no_dev/Loss_LogF0_Interaction"] > 0
    assert "dev/ObjEval_MGC_MCD" in metrics(dirs["port"])[1]


def test_judges_fail_a_frozen_leaf(acoustic_runs):
    """A planted fault: each parameter leaf in turn left at its start
    value in both of the port's runs.  The float64 check fails every leaf
    that the JAX float64 run moved by more than 2e-6 of its scale (the
    others, the conv biases in front of each batch norm, have no gradient
    in exact arithmetic), and the float32 judge with its oracle fails
    each leaf that the run moved by more than 4e-4 of its scale (above
    AR_HEADROOM times 1e-4)."""
    dirs, start = acoustic_runs
    p0 = {k: torch.from_numpy(v) for k, v in params(start).items()}
    pj, pp = final_params(dirs["jax"]), final_params(dirs["port"])
    pj64, pp64 = final_params(dirs["jax64"]), final_params(dirs["port64"])
    floor = chip_smoke.GRAD_SCALE_FLOOR * max(
        v.abs().max().item() for v in pj.values())
    moved = {"float64": 0, "float32": 0}
    for k in pp:
        scale = max(pj64[k].abs().max().item(), floor)
        update = (pj64[k] - p0[k].double()).abs().max().item() / scale
        if update > 2 * F64_RTOL:
            moved["float64"] += 1
            assert k in judge_params({**pp64, k: p0[k].double()}, pj64,
                                     rtol=F64_RTOL), k
        if update > 4 * RTOL:
            moved["float32"] += 1
            assert k in judge_params({**pp, k: p0[k]}, pj, pj64), k
    assert moved["float64"] > 0.8 * len(pp), (moved, len(pp))
    assert moved["float32"] > len(pp) // 2, (moved, len(pp))
