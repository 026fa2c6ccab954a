"""The port's data-parallel training on 2 gloo ranks on the CPU against the
JAX package's global-view program on ``make_mesh(2)``.

Each rank is a subprocess (``tests/torch_parallel_worker.py``) that
imports no JAX, joined over a loopback port.  The JAX side runs in this
process on two of the suite's virtual CPU devices.

* The multitrack acoustic step (the tiny flagship of
  ``tests/test_torch_train.py``: masked batch norm in its FFConvLSTM
  decoders) over 2 SGD steps on a batch of mixed lengths whose last row,
  on rank 1, is a length-0 padding row: the loss and the updated
  parameters and running statistics within 1e-5 of JAX's step on the
  batch sharded by ``shard_batch``, and within 1e-6 of the port's
  one-process step on the whole batch.  The planted fault, per-rank
  masked means and batch statistics with averaged gradients (what
  ``DistributedDataParallel`` computes), misses JAX's by more than 1e-5.
* ``train_multitrack_model`` as 2 ranks against the JAX trainer with
  ``make_mesh`` patched to ``make_mesh(2)``, 2 epochs, by
  ``tests/test_torch_trainer_multitrack.assert_trainers_agree`` (metrics
  and final parameters at 1e-4); only rank 0 writes.  ``train_model`` is
  held so in ``tests/test_torch_parallel_trainer.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.parallel import make_mesh
from ensemble_svs_with_interactions_tpu.parallel import mesh as jax_mesh
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import multitrack as jax_mt
from ensemble_svs_with_interactions_tpu.train import (
    multitrack_trainer as jax_mt_trainer,
)
from ensemble_svs_with_interactions_tpu.utils.config import _wrap
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    merge,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests import test_torch_trainer_multitrack as multi
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_torch_parallel import (
    WORLD,
    finish_ranks,
    free_port,
    start_ranks,
)
from tests.test_torch_train import SS, _config, _flagship, _port_step

ATOL = 1e-5
ONE_PROCESS_ATOL = 1e-6
STEPS = 2
SGD = {"name": "SGD", "params": {"lr": 0.5}}
B, T = 4, 32
LENGTHS = (32, 25, 14, 0)  # rank 1 holds rows 2 and 3: a padding row
METRICS = ("Loss", "Loss_Feats", "Loss_Pitch", "Loss_LogF0_Interaction",
           "GradNorm")


# --------------------------------------------------------------- the step
def step_batch(seed=7):
    rng = np.random.default_rng(seed)
    out_dim = sum(SS)
    lengths = np.asarray(LENGTHS, np.int32)
    valid = (np.arange(T)[None, :] < lengths[:, None])[:, :, None]
    return {
        "in_feats0": (rng.uniform(0, 1, (B, T, 86)) * valid).astype(
            np.float32),
        "in_feats1": (rng.uniform(0, 1, (B, T, 86)) * valid).astype(
            np.float32),
        "out_feats0": (rng.normal(size=(B, T, out_dim)) * valid).astype(
            np.float32),
        "out_feats1": (rng.normal(size=(B, T, out_dim)) * valid).astype(
            np.float32),
        "spks0": np.array([0, 1, 2, 0], np.int32),
        "spks1": np.array([1, 2, 0, 0], np.int32),
        "lengths": lengths,
    }


def jax_steps(jm, variables, batch):
    """JAX's multitrack step on ``make_mesh(2)``: the state replicated,
    the batch sharded (``shard_batch``), as its trainer runs it."""
    tx = jax_loop.build_optimizer(SGD)
    jstep, _ = jax_mt.create_multitrack_acoustic_train_step(
        jm, tx, {"stream_sizes": SS}, pitch_reg_weight=1.0, donate=False)
    mesh = make_mesh(WORLD)
    state = jax_mesh.replicate_tree(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"],
         "opt_state": tx.init(variables["params"]),
         "step": jnp.asarray(0)}, mesh)
    sharded = jax_mesh.shard_batch(batch, mesh)
    weights = {"logf0_diff": jnp.asarray(1.0), "mgc_diff": jnp.asarray(1.0)}
    metrics = []
    for _ in range(STEPS):
        state, m = jstep(state, sharded, weights, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, flax_to_torch(
        instantiate(_config()),
        jax.tree_util.tree_map(np.asarray, {
            "params": state["params"],
            "batch_stats": state["batch_stats"]})).state_dict()


def one_process_steps(variables, batch):
    module, _, (train_step, _) = _port_step(_config(), variables, SGD)
    g = torch.Generator().manual_seed(0)
    weights = {"logf0_diff": 1.0, "mgc_diff": 1.0}
    metrics = [train_step(batch, weights, g) for _ in range(STEPS)]
    return metrics, module.state_dict()


def start_rank_steps(root, variables, batch, ddp=False):
    root.mkdir(parents=True, exist_ok=True)
    start = flax_to_torch(instantiate(_config()), variables).state_dict()
    torch.save(start, root / "state.pt")
    np.savez(root / "batch.npz", **batch)
    job = {"kind": "step", "port": free_port(), "world": WORLD,
           "config": _config(), "state": str(root / "state.pt"),
           "batch": str(root / "batch.npz"), "optimizer": SGD,
           "stream_sizes": SS, "steps": STEPS, "ddp": ddp}
    return start_ranks(root, [job] * WORLD)


def assert_steps_close(got, ref, atol):
    """(metrics list, state dict) pairs: every metric within ``atol``
    relative, every parameter and running statistic within ``atol``."""
    for g, r in zip(got[0], ref[0]):
        for k in METRICS:
            assert abs(g[k] - r[k]) <= atol * max(abs(r[k]), 1.0), (
                k, g[k], r[k])
    for k, v in ref[1].items():
        np.testing.assert_allclose(got[1][k].numpy(), v.numpy(), atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The 2-rank step (and its planted DDP variant), JAX's on the mesh
    and the port's one-process step, from one start and batch."""
    root = tmp_path_factory.mktemp("dp_step")
    _, jm, variables = _flagship()
    batch = step_batch()
    started = [start_rank_steps(root / name, variables, batch, ddp=ddp)
               for name, ddp in (("ranks", False), ("ddp", True))]
    out = {"jax": jax_steps(jm, variables, batch),
           "one": one_process_steps(variables, batch)}
    out["ranks"], out["ddp"] = (finish_ranks(s) for s in started)
    return out


def test_ranks_agree_and_hold_the_global_step(step_runs):
    """Both ranks end with the same parameters and log the same global
    metrics."""
    r0, r1 = step_runs["ranks"]
    assert r0["world_size"] == r1["world_size"] == WORLD
    assert r0["metrics"] == r1["metrics"]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k


def test_two_rank_step_matches_jax_mesh(step_runs):
    r0 = step_runs["ranks"][0]
    assert r0["metrics"][0]["GradNorm"] > 1.0  # the clip was active
    assert_steps_close((r0["metrics"], r0["state"]), step_runs["jax"], ATOL)


def test_two_rank_step_matches_one_process(step_runs):
    r0 = step_runs["ranks"][0]
    assert_steps_close((r0["metrics"], r0["state"]), step_runs["one"],
                       ONE_PROCESS_ATOL)


def test_ddp_style_per_rank_means_fail(step_runs):
    """The planted fault: per-rank means averaged as DDP averages them
    miss JAX's global step by more than the 1e-5 the real one meets."""
    r0 = step_runs["ddp"][0]
    with pytest.raises(AssertionError):
        assert_steps_close((r0["metrics"], r0["state"]), step_runs["jax"],
                           ATOL)


# ------------------------------------------------------------ the trainers
def run_jax_trainer(trainer, fn, init_name, cfg, *args, **kw):
    """A JAX trainer on ``make_mesh(2)``, its initializer traced (every run
    resumes from a start checkpoint)."""
    orig = trainer.make_mesh, getattr(trainer, init_name)
    trainer.make_mesh = lambda: make_mesh(WORLD)
    setattr(trainer, init_name, multi.traced_init(orig[1]))
    try:
        fn(_wrap(dict(cfg)), *args, **kw)
    finally:
        trainer.make_mesh = orig[0]
        setattr(trainer, init_name, orig[1])


def start_rank_trainers(root, cfg, multitrack: bool, acoustic: bool):
    """The port's trainer as ``WORLD`` ranks over gloo, each joining from
    its config's ``distributed`` section, started."""
    port = free_port()
    return start_ranks(root, [{
        "kind": "trainer", "port": port, "world": WORLD,
        "config": merge(cfg, {"distributed": {
            "coordinator": f"127.0.0.1:{port}", "num_processes": WORLD,
            "process_id": r}}),
        "multitrack": multitrack, "acoustic": acoustic}
        for r in range(WORLD)])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return chip_smoke.write_corpus(tmp_path_factory.mktemp("corpus"), 2, 1,
                                   (40, 64), seed=5,
                                   timing_dim=multi.TIMING_DIM)


def both_trainers(tmp_path, cfg, start, jax_run, multitrack, acoustic):
    """The JAX trainer on ``make_mesh(2)`` (in this process) and the port's
    on 2 ranks (started first, so both sides run at once) from one start,
    by ``assert_trainers_agree``.  Returns the run directories."""
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}

    def config(side):
        return merge(cfg, {"train": {"out_dir": str(dirs[side]),
                                     "use_amp": False,
                                     "resume": {"checkpoint": str(start)}}})

    started = start_rank_trainers(tmp_path / "ranks", config("port"),
                                  multitrack, acoustic)
    jax_run(config("jax"))
    results = finish_ranks(started)
    assert results[0]["dev"] == results[1]["dev"]
    assert all(r["world_size"] == WORLD for r in results)
    multi.assert_trainers_agree(dirs)
    return dirs


def test_multitrack_trainer_on_two_ranks_matches_jax(corpus, tmp_path):
    """The recipe's acoustic phase on the tiny flagship (masked batch
    norm, the interaction losses, the pitch regularization, random crops
    padded to an even batch, a dev pass with distortions), 2 ranks."""
    cfg = multi.phase_config("acoustic", corpus, tmp_path,
                             multi.acoustic_model(),
                             **{**multi.ACOUSTIC_DATA,
                                "train.logf0_diff_weight": 1.0,
                                "train.mgc_diff_weight": 1.0})
    start = multi.jax_start(cfg, True, tmp_path / "start")
    dirs = both_trainers(
        tmp_path, cfg, start,
        lambda c: run_jax_trainer(jax_mt_trainer,
                                  jax_mt_trainer.train_multitrack_model,
                                  "_init_multitrack_variables", c, True),
        multitrack=True, acoustic=True)
    written = sorted(p.name for p in dirs["port"].iterdir())
    assert "metrics.jsonl" in written and "best_loss.ckpt" in written
    first = multi.metrics(dirs["port"])[0]
    assert first["train_no_dev/Loss_Pitch"] > 0
