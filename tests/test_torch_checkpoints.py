"""The port's checkpoints, the recipe's configuration quirks and the
training CLIs on the CPU.

* A port ``best_loss.ckpt`` is read by the JAX package's stage-6 code path
  (``bin/run_recipe.py``: ``msgpack_restore`` then ``from_state_dict``
  into the template ``_init_multitrack_variables`` gives) and the JAX
  model with those variables gives the port's outputs within 1e-5.
* A JAX checkpoint warm-starts the port through
  ``load_params_shape_filtered`` with the same count copied as JAX's, the
  same tensors, bitwise; a single-track checkpoint warm-starts a
  multitrack model on both sides alike.
* ``load_checkpoint`` restores a run's parameters, batch statistics,
  Adam moments and count, schedule and step bitwise, and training goes on
  from there bitwise as it would have.
* ``load_checkpoint`` restores a gradient accumulator stopped between
  updates bitwise.
* The four CLIs train a tiny config with ``key=value`` overrides on the
  CPU; the acoustic ones with ``train.eval_render`` write the dev renders.
* The recipe's quirks: ``checkpoint_epoch_interval`` is not read, and
  its multitrack timing configs' ``in_dim`` cannot take its features;
  the trainers refuse more than one process, leave cuDNN's TF32 switch
  alone and write JSONL when MLflow is missing.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax import traverse_util

import chip_smoke
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.utils.config import _wrap
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.bin import (
    train,
    train_acoustic,
    train_acoustic_multitrack,
    train_multitrack,
)
from ensemble_svs_with_interactions_tpu_torch.train import loop
from ensemble_svs_with_interactions_tpu_torch.train.multitrack_trainer import (
    train_multitrack_model,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_init
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    merge,
    save_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_trainer import single_acoustic_model
from tests.test_torch_trainer_multitrack import (
    _EAGER_INITS,
    ACOUSTIC_DATA,
    TIMING_DATA,
    acoustic_model,
    init_multitrack,
    init_single,
    timing_model,
    traced_init,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

TIMING_DIM = 12
RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return chip_smoke.write_corpus(tmp_path_factory.mktemp("corpus"), 2, 1,
                                   (40, 64), seed=7, timing_dim=TIMING_DIM)


def acoustic_config(corpus, out_dir, **overrides):
    """The recipe's acoustic phase (Adam, StepLR, AMP off) on the tiny
    flagship, one epoch."""
    cfg = chip_smoke.recipe_phase_config(
        "acoustic", corpus, out_dir,
        **{**ACOUSTIC_DATA, "train.nepochs": 1, "train.use_amp": False,
           **overrides})
    return merge(cfg, {"model": acoustic_model()})


def _flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def one_epoch(corpus, tmp_path_factory):
    """(config, run directory) of one epoch of ``acoustic_config`` by the
    port's trainer, which the checkpoint tests below read."""
    out = tmp_path_factory.mktemp("one_epoch")
    cfg = acoustic_config(corpus, out)
    train_multitrack_model(cfg, True, device="cpu")
    return cfg, out


def test_port_checkpoint_is_read_by_the_jax_stage6_path(one_epoch):
    """The JAX recipe's stage 6 on a port checkpoint: the tiny flagship's
    teacher-forced evaluation forward (both tracks, running statistics)
    on the JAX side with the restored variables against the port's
    module as the checkpoint left it."""
    cfg, out = one_epoch
    ckpt = out / "best_loss.ckpt"

    jm = jax_instantiate(cfg["model"]["netG"])
    # the template's structure (its values are all replaced below)
    template = jax.eval_shape(lambda: init_multitrack(jm, _wrap(dict(cfg)),
                                                      True))
    tree = serialization.msgpack_restore(ckpt.read_bytes())
    variables = dict(template)
    variables["params"] = serialization.from_state_dict(template["params"],
                                                        tree["params"])
    variables["batch_stats"] = serialization.from_state_dict(
        template["batch_stats"], tree["batch_stats"])

    module = instantiate(cfg["model"]["netG"])
    loop.load_checkpoint(ckpt).restore(module)
    rng = np.random.default_rng(0)
    B, T = 2, 64
    x0, x1 = (rng.uniform(0, 1, (B, T, 86)).astype(np.float32)
              for _ in range(2))
    y0, y1 = (rng.normal(size=(B, T, 67)).astype(np.float32)
              for _ in range(2))
    spks, lengths = (np.array([0, 1]), np.array([2, 0])), np.array([T, 50])
    ref = jm.apply(variables, jnp.asarray(x0), jnp.asarray(x1),
                   tuple(jnp.asarray(s) for s in spks), jnp.asarray(lengths),
                   (jnp.asarray(y0), jnp.asarray(y1)), train=False,
                   rngs={"prenet": jax.random.PRNGKey(0)})
    t = torch.from_numpy
    with torch.no_grad():
        got = module(t(x0), t(x1), tuple(t(s) for s in spks), t(lengths),
                     (t(y0), t(y1)), train=False)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = [g for pair in got for g in pair]
    assert len(got_leaves) == len(ref_leaves) == 4
    for g, r in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=RTOL)


@pytest.mark.parametrize("source", ["multitrack", "single_track"])
def test_jax_checkpoint_warm_starts_the_port(tmp_path, source):
    """``train.resume.checkpoint``'s partial restore: a JAX checkpoint of
    the same model copies every tensor; one of the single-track voice
    copies the tensors whose path and shape the multitrack model shares
    (the decoders), on both sides alike."""
    target = acoustic_model()["netG"]
    src_cfg = (acoustic_model() if source == "multitrack"
               else single_acoustic_model())
    jm = jax_instantiate(src_cfg["netG"])
    cfg = _wrap({"model": src_cfg})
    # the JAX trainers' variable trees (traced, not compiled), the
    # checkpoint's every leaf a seeded normal draw
    shapes = (jax.eval_shape(lambda: init_multitrack(jm, cfg, True))
              if source == "multitrack"
              else jax.eval_shape(lambda: init_single(jm, cfg)))
    rng = np.random.default_rng(3)
    v = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)
    jax_loop.save_checkpoint(tmp_path, jax_loop.TrainState(
        v["params"], v.get("batch_stats", {}), {}, 0), 0)
    ckpt = tmp_path / "latest.ckpt"

    jt = jax_instantiate(target)
    template = traced_init(_EAGER_INITS[0])(
        jt, _wrap({"model": {"netG": target}}), True)
    ref, ref_copied = jax_loop.load_params_shape_filtered(ckpt, template)

    module = instantiate(target)
    got, copied = loop.load_params_shape_filtered(
        ckpt, flax_init.init_variables(module, 0))
    assert copied == ref_copied
    total = len(_flat(template["params"]))
    assert copied == total if source == "multitrack" else 0 < copied < total
    src = _flat(v["params"])
    got_flat, ref_flat = _flat(got["params"]), _flat(ref["params"])
    for k, r in ref_flat.items():
        if k in src and src[k].shape == r.shape:
            np.testing.assert_array_equal(got_flat[k], r, err_msg=k)
    flax_to_torch(module, got)  # every leaf fits the port module


def _capture(module, optimizer, scheduler, step):
    return _flat(loop.TrainState.capture(module, optimizer, scheduler,
                                         step).as_pytree())


def test_load_checkpoint_round_trip_is_bitwise(one_epoch):
    """After one epoch with the recipe's Adam and StepLR: the checkpoint
    restored into a fresh module, optimizer and schedule captures the same
    state bitwise, and one more Adam step from each agrees bitwise."""
    cfg, out = one_epoch
    state = loop.load_checkpoint(out / "latest.ckpt")
    assert state.step == 3 and state.opt_state["moments"]

    def fresh():
        module = instantiate(cfg["model"]["netG"])
        opt, sched = loop.build_optimizer(
            module.parameters(), dict(cfg["train"]["optim"]["optimizer"]),
            dict(cfg["train"]["optim"]["lr_scheduler"]), steps_per_epoch=3)
        state.restore(module, opt, sched)
        return module, opt, sched

    a, b = fresh(), fresh()
    before = _flat(state.as_pytree())
    after = _capture(*a, state.step)
    assert sorted(before) == sorted(after)
    for k, v in before.items():
        assert v.dtype == after[k].dtype and np.array_equal(v, after[k]), k
    assert a[1].param_groups[0]["lr"] == b[1].param_groups[0]["lr"]

    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack as mt,
    )

    batch = chip_smoke.train_batch(2, 32, 67)
    for module, opt, sched in (a, b):
        step, _ = mt.create_multitrack_acoustic_train_step(
            module, opt, cfg["model"], scheduler=sched, device="cpu")
        step(batch, {"logf0_diff": 0.0, "mgc_diff": 0.0},
             torch.Generator().manual_seed(0))
    for (k, x), y in zip(a[0].state_dict().items(),
                         b[0].state_dict().values()):
        assert torch.equal(x, y), k


def test_load_checkpoint_restores_gradient_accumulation(tmp_path):
    """``accum_steps`` 2 stopped between updates: the accumulator's mean
    and count come back bitwise, and the next two steps agree bitwise."""
    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack as mt,
    )

    net = timing_model("timelag")["netG"]
    net.update(in_dim=82, num_speaker=4)  # chip_smoke.timing_batch's

    def build(state=None):
        module = flax_init.init_module(instantiate(net), 0)
        opt, sched = loop.build_optimizer(
            module.parameters(), {"name": "Adam", "params": {"lr": 1e-2}},
            {"name": "StepLR", "params": {"step_size": 1, "gamma": 0.5}},
            accum_steps=2)
        if state is not None:
            state.restore(module, opt, sched)
        step, _ = mt.create_multitrack_timing_train_step(
            module, opt, scheduler=sched, device="cpu")
        return module, opt, sched, step

    batch = chip_smoke.timing_batch(3, 3, (4, 9))
    module, opt, sched, step = build()
    for _ in range(3):
        step(batch, None)
    assert opt.mini_step == 1
    loop.save_checkpoint(tmp_path, loop.TrainState.capture(
        module, opt, sched, 3), 1)
    state = loop.load_checkpoint(tmp_path / "latest.ckpt")
    twin = build(state)
    before = _flat(state.as_pytree())
    after = _capture(*twin[:3], 3)
    for k, v in before.items():
        assert np.array_equal(v, after[k]), k
    for _ in range(2):
        step(batch, None)
        twin[3](batch, None)
    for (k, x), y in zip(module.state_dict().items(),
                         twin[0].state_dict().values()):
        assert torch.equal(x, y), k


def test_checkpoint_interval_is_the_key_jax_reads(corpus, tmp_path):
    """The recipe sets ``checkpoint_epoch_interval`` (50); the trainers
    read ``checkpoint_interval``, so the recipe's runs write no
    ``epoch%04d.ckpt``.  The port reads the key JAX reads."""
    model = timing_model("timelag")
    model["netG"]["in_dim"] = TIMING_DIM
    for key, written in (("checkpoint_epoch_interval", False),
                         ("checkpoint_interval", True)):
        out = tmp_path / key
        cfg = merge(chip_smoke.recipe_phase_config(
            "timelag", corpus, out, **{**TIMING_DATA, "train.nepochs": 2,
                                       f"train.{key}": 1}),
            {"model": model})
        train_multitrack_model(cfg, False, device="cpu")
        assert (out / "epoch0001.ckpt").exists() == written
        assert (out / "epoch0002.ckpt").exists() == written
        assert (out / "latest.ckpt").exists()


def test_trainers_refuse_more_than_one_process(corpus, tmp_path):
    """A data-parallel config (``parallel/mesh.py``) that names a
    coordinator and two processes but not this process's rank is refused
    before it joins anything."""
    cfg = merge(acoustic_config(corpus, tmp_path),
                {"distributed": {"coordinator": "127.0.0.1:1",
                                 "num_processes": 2}})
    with pytest.raises(ValueError, match="process_id"):
        train_multitrack_model(cfg, True, device="cpu")


def test_metrics_writer_gives_way_without_the_packages(tmp_path):
    """JSONL always; MLflow (not installed here) falls back with a
    warning."""
    with pytest.warns(UserWarning, match="mlflow"):
        writer = loop.MetricsWriter(tmp_path, use_tensorboard=False,
                                    use_mlflow=True)
    writer.log(1, {"Loss": 0.5}, prefix="dev/")
    writer.close()
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == {
        "step": 1, "dev/Loss": 0.5}


# ---------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("cli,phase,multitrack", [
    (train_acoustic_multitrack, "acoustic", True),
    (train_multitrack, "timelag", True),
    (train_acoustic, "acoustic", False),
    (train, "duration", False),
])
def test_clis_train_with_overrides(corpus, tmp_path, cli, phase, multitrack):
    """``config.yaml key=value ...`` on the CPU: the overrides reach the
    trainer (one epoch, SGD, another out_dir)."""
    if phase == "acoustic":
        model = acoustic_model() if multitrack else single_acoustic_model()
        data = ACOUSTIC_DATA
    else:
        model = (timing_model(phase) if multitrack else
                 chip_smoke.shipped_config(f"{phase}/{phase}_vp_mdn.yaml"))
        model["netG"].update(in_dim=TIMING_DIM, hidden_dim=8, num_layers=2)
        data = TIMING_DATA
    cfg = merge(chip_smoke.recipe_phase_config(
        phase, corpus, tmp_path / "unused", multitrack=multitrack, **data),
        {"model": model})
    path = tmp_path / "config.yaml"
    save_config(json.loads(json.dumps(cfg)), path)
    out = tmp_path / "exp"
    render = ["train.eval_render=true"] if phase == "acoustic" else []
    assert cli.main([str(path), "train.nepochs=1", f"train.out_dir={out}",
                     "train.optim.optimizer.name=SGD", "device=cpu",
                     *render]) == 0
    if render:  # the first dev batch's audio (train/eval_render.py)
        from scipy.io import wavfile

        sr, wav = wavfile.read(out / "eval" / "epoch0001" / "utt0_pred.wav")
        assert sr == 48000 and wav.dtype == np.int16 and len(wav) > 0
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 1]
    assert (out / "best_loss.ckpt").exists()
    assert (out / "dev_metrics.json").exists()
    assert not (tmp_path / "unused").exists()
    assert cli.main([]) == 1


def test_shipped_multitrack_timing_in_dim_is_both_tracks_width(tmp_path):
    """The recipe's multitrack timing configs say ``in_dim: 164``, both
    tracks' width in the reference; the JAX model (and the port's) takes
    ``2 * in_dim``, so neither runs on the recipe's 82 note features a
    track.  ``chip_smoke.recipe_phase_config`` sets 82."""
    from flax.errors import ScopeParamShapeError

    net = chip_smoke.shipped_config(
        "timelag/multitrack_timelag_vp_mdn.yaml")["netG"]
    assert net["in_dim"] == 164
    jm = jax_instantiate(net)
    v = init_multitrack(jm, _wrap({"model": {"netG": net}}), False)
    assert v["params"]["Conv_0"]["kernel"].shape[1] == 2 * 164 + 32
    spks = (jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32))
    with pytest.raises(ScopeParamShapeError):
        jm.apply(v, jnp.zeros((1, 5, 2 * 82)), spks, jnp.asarray([5]))
    port = instantiate(net)
    with pytest.raises(RuntimeError):
        port(torch.zeros(1, 5, 2 * 82), (torch.zeros(1).long(),) * 2)
    cfg = chip_smoke.recipe_phase_config("timelag", tmp_path, tmp_path)
    assert cfg["model"]["netG"]["in_dim"] == chip_smoke.TIMING_DIM == 82


@pytest.mark.parametrize("tf32", [False, True])
def test_trainer_leaves_the_tf32_switch_as_it_found_it(corpus, tmp_path,
                                                       tf32):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = timing_model("timelag")
        model["netG"]["in_dim"] = TIMING_DIM
        cfg = merge(chip_smoke.recipe_phase_config(
            "timelag", corpus, tmp_path, **{**TIMING_DATA,
                                            "train.nepochs": 1}),
            {"model": model})
        train_multitrack_model(cfg, False, device="cpu")
        assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
