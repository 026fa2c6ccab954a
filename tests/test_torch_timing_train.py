"""The port's multitrack timelag/duration train step against the JAX
package's ``create_multitrack_timing_train_step`` at tiny width.

The models are ``bench.py``'s timing models (``MultiTrackVariancePredictor``
with an MDN head of 4 gaussians: timelag 3 layers of kernel 3 and 3
outputs, duration 5 layers of kernel 5 and 1 output), narrowed to hidden
width 8, with dropout 0 (masks cannot match across frameworks), and a
duration model with a linear head for the MSE loss.  Batches are built
with the port's ``merge_tracks_by_notes`` from seeded numpy, so ``mask0``
is false where only the sub track has a note and the lengths are padded.

Tolerances.  The float32 arm: the parameters after one SGD step at atol
1e-5, as ``test_torch_train.py`` holds the acoustic step, and each metric
by ``chip_smoke.judge_f32`` at 1e-5: within 1e-5 of its value, or, where
float32 does not resolve it that well (the duration model's gradient
norm, to about 1e-5 on either side), no more than 3 times as far as
JAX's from the port's float64 step.  The AMP arm, by
``chip_smoke.judge_amp``: each metric and each parameter's SGD update
within 2e-2 of its scale, max(its largest JAX entry, 1e-3 x the largest
entry of any update), since bf16 rounds at 2**-9 relative through a few
conv and LayerNorm layers.  JAX's AMP step lies up to 89% of the scale
from its float32 update; the port follows it to 0.025 of the scale at
worst.  An update outside 2e-2 passes only at cosine 0.999 or more with
JAX's and an L2 distance at most 0.05 of its norm (readings, printed by
``python -m tests.test_torch_timing_train``: cosine 0.9998 and 0.022 at
worst), and no farther from the port's float32 step than 3 times JAX's
(or 3 x 2e-2 of the scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import multitrack as jax_mt
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.train import loop
from ensemble_svs_with_interactions_tpu_torch.train import multitrack as mt
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

PKG = "ensemble_svs_with_interactions_tpu.models"
IN_DIM = 82
N_SPK = 4
B = 3
AMP_RTOL = 2e-2
AMP_COS_MIN = 0.999
AMP_L2_MAX = 0.05
SGD = {"name": "SGD", "params": {"lr": 0.5}}

# bench.py:168-193 at hidden width 8 (timelag 32, duration 256 there)
MODELS = {
    "timelag": {"out_dim": 3, "num_layers": 3, "kernel_size": 3,
                "use_mdn": True},
    "duration": {"out_dim": 1, "num_layers": 5, "kernel_size": 5,
                 "use_mdn": True},
    "duration_mse": {"out_dim": 1, "num_layers": 5, "kernel_size": 5,
                     "use_mdn": False},
}


def _config(name, dropout=0.0):
    return {"_target_": f"{PKG}.MultiTrackVariancePredictor",
            "in_dim": IN_DIM, "hidden_dim": 8, "num_gaussians": 4,
            "init_type": "kaiming_normal", "num_speaker": N_SPK,
            "spk_embed_dim": 16, "dropout": dropout, **MODELS[name]}


def _batch(seed, out_dim):
    """B note-merged track pairs of 4-8 notes each
    (``chip_smoke.timing_batch``: the JAX batch iterator's layout, padded
    to a multiple of 8, ``mask0`` False where the main track has no
    note).  Note end times are cumulative sums of small integers, so the
    tracks share some boundaries and differ at others."""
    batch = chip_smoke.timing_batch(B, out_dim, (4, 9), seed)
    lengths, T = batch["lengths"], batch["mask0"].shape[1]
    assert (lengths < T).any() and not batch["mask0"][
        np.arange(T)[None, :] < lengths[:, None]].all()
    return batch


def _jax_args(b):
    return (jnp.asarray(np.concatenate([b["in_feats0"], b["in_feats1"]], -1)),
            (jnp.asarray(b["spks0"]), jnp.asarray(b["spks1"])),
            jnp.asarray(b["lengths"]))


def _twins(name):
    """(name, config, JAX module, flax variables) of one timing model."""
    cfg = _config(name)
    jm = jax_instantiate(cfg)
    variables = jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *_jax_args(_batch(0, cfg["out_dim"])), train=True)
    return name, cfg, jm, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module", params=list(MODELS))
def twins(request):
    return _twins(request.param)


def _jax_step(jm, variables, batch, use_amp):
    """One JAX SGD step: (metrics, new params, eval metrics before it)."""
    tx = jax_loop.build_optimizer(SGD)
    step, eval_step = jax_mt.create_multitrack_timing_train_step(
        jm, tx, clip_norm=1.0, use_amp=use_amp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = {"params": variables["params"], "batch_stats": {},
             "opt_state": tx.init(variables["params"]),
             "step": jnp.asarray(0)}
    evaluated = {k: float(v) for k, v in eval_step(state, jbatch).items()}
    new_state, metrics = step(state, jbatch, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, new_state["params"]),
            evaluated)


def _port_step(cfg, variables, opt_cfg, use_amp, dtype=torch.float32,
               **kw):
    module = flax_to_torch(instantiate(cfg), variables).to(dtype)
    opt, sched = loop.build_optimizer(module.parameters(), opt_cfg, **kw)
    step, eval_step = mt.create_multitrack_timing_train_step(
        module, opt, scheduler=sched, clip_norm=1.0, use_amp=use_amp,
        device="cpu")
    return module, opt, step, eval_step


def _port_run(cfg, variables, batch, use_amp, dtype=torch.float32):
    """One port SGD step: (metrics with the evaluation's loss before it as
    ``Eval_Loss``, the update of every parameter)."""
    module, _, step, eval_step = _port_step(cfg, variables, SGD, use_amp,
                                            dtype=dtype)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    metrics = {"Eval_Loss": eval_step(batch)["Loss"],
               **step(batch, torch.Generator().manual_seed(0))}
    return metrics, {k: (v - before[k]).double() for k, v in
                     module.state_dict().items()}


def _runs(twins, use_amp):
    """Evaluation, then one SGD step on each side: ((port, JAX, oracle)
    metrics, (port, JAX, oracle) parameter updates), each a {name:
    tensor}; the oracle is the port's step in float64 for the float32
    arm and in float32 for the AMP arm."""
    name, cfg, jm, variables = twins
    batch = _batch(1, cfg["out_dim"])
    ref, ref_params, ref_eval = _jax_step(jm, variables, batch, use_amp)
    before = flax_to_torch(instantiate(cfg), variables).state_dict()
    want = flax_to_torch(instantiate(cfg), {"params": ref_params}).state_dict()
    ref = {"Eval_Loss": ref_eval["Loss"], **ref}
    ref_updates = {k: (want[k] - before[k]).double() for k in want}
    got, updates = _port_run(cfg, variables, batch, use_amp)
    oracle, oracle_updates = _port_run(
        cfg, variables, batch, False,
        torch.float32 if use_amp else torch.float64)
    as_t = lambda m: {k: torch.tensor(m[k]) for k in ref}  # noqa: E731
    return ((as_t(got), as_t(ref), as_t(oracle)),
            (updates, ref_updates, oracle_updates))


@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "amp"])
def test_timing_step_matches_jax(twins, use_amp):
    """Evaluation, then one SGD step: the metrics and each parameter's
    update by the arm's rule (module docstring), with the port's float64
    step as the float32 arm's oracle and its float32 step as the AMP
    arm's."""
    (got, ref, oracle), (updates, ref_updates, oracle_updates) = _runs(
        twins, use_amp)
    if use_amp:
        judged = [chip_smoke.judge_amp(*run, AMP_RTOL, AMP_COS_MIN,
                                       AMP_L2_MAX)
                  for run in ((got, ref, oracle),
                              (updates, ref_updates, oracle_updates))]
    else:
        judged = [chip_smoke.judge_f32(got, ref, oracle, rtol=1e-5)]
        for k, u in updates.items():
            np.testing.assert_allclose(u.numpy(), ref_updates[k].numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
    for j in judged:
        bad = {k: v for k, v in j.items() if not v["ok"]}
        assert not bad, bad


def test_timing_loss_is_the_masked_criterion(twins):
    """The loss counts the valid positions where the main track has a note
    (``valid x mask0``): changing a target where mask0 is False leaves it
    as it is, changing one where it is True does not."""
    name, cfg, _, variables = twins
    *_, eval_step = _port_step(cfg, variables, SGD, use_amp=False)
    batch = _batch(2, cfg["out_dim"])
    loss = eval_step(batch)["Loss"]
    valid = np.arange(batch["mask0"].shape[1])[None, :] < batch[
        "lengths"][:, None]
    off = np.argwhere(valid & ~batch["mask0"])[0]
    on = np.argwhere(batch["mask0"])[0]
    moved = {k: v.copy() for k, v in batch.items()}
    moved["out_feats0"][off[0], off[1]] += 3.0
    assert eval_step(moved)["Loss"] == loss
    moved["out_feats0"][on[0], on[1]] += 3.0
    assert eval_step(moved)["Loss"] != loss


@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "amp"])
def test_timing_nan_skips_params_and_optimizer_state(twins, use_amp):
    """A non-finite batch leaves the parameters and Adam's state bitwise
    as they were.  The JAX timing step guards only its parameters and
    stores the new optimizer state; the port guards both, as its acoustic
    step and the JAX acoustic step do."""
    name, cfg, _, variables = twins
    module, opt, step, _ = _port_step(
        cfg, variables, {"name": "Adam", "params": {"lr": 1e-3}}, use_amp)
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(step(_batch(3, cfg["out_dim"]), g)["Loss"])
    params = {k: v.clone() for k, v in module.named_parameters()}
    state = {id(p): {n: t.clone() for n, t in s.items()}
             for p, s in opt.state.items()}
    bad = _batch(4, cfg["out_dim"])
    bad["out_feats0"][0, 0, 0] = np.nan
    assert not np.isfinite(step(bad, g)["Loss"])
    for k, v in module.named_parameters():
        assert torch.equal(v, params[k]), k
    for p, s in opt.state.items():
        for n, t in s.items():
            assert torch.equal(t, state[id(p)][n]), n


def test_variance_predictor_training_dropout():
    """``train=True`` applies dropout after each LayerNorm with masks from
    the generator: the same seed gives the same output, another seed
    another, p = 0 gives the inference output bitwise, and the default
    call stays the inference path."""
    batch = _batch(5, 1)
    x = torch.from_numpy(np.concatenate([batch["in_feats0"],
                                         batch["in_feats1"]], -1))
    spks = (torch.from_numpy(batch["spks0"]).long(),
            torch.from_numpy(batch["spks1"]).long())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = instantiate(_config("duration", dropout=0.5))
    still = instantiate(_config("duration", dropout=0.0))
    still.load_state_dict(model.state_dict())

    def run(m, **kw):
        with torch.no_grad():
            return m(x, spks, **kw)

    infer = run(model)
    assert all(torch.equal(a, b) for a, b in
               zip(infer, run(model, train=False)))
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = run(model, train=True, generator=gen(1))
    assert all(torch.equal(u, v) for u, v in
               zip(a, run(model, train=True, generator=gen(1))))
    assert not torch.equal(a[2], run(model, train=True, generator=gen(2))[2])
    assert not torch.equal(a[2], infer[2])
    assert all(torch.equal(u, v) for u, v in
               zip(infer, run(still, train=True, generator=gen(1))))
    with pytest.raises(ValueError, match="Generator"):
        run(model, train=True)


def test_timing_step_trains_with_dropout_and_accumulation():
    """The recipe's settings: dropout 0.5 (masks from the step's
    generator), AMP and accum_steps = 2 with Adam; the parameters move
    only on the second micro-step, and the loss stays finite."""
    cfg = _config("duration", dropout=0.5)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = instantiate(cfg)
    opt, sched = loop.build_optimizer(
        module.parameters(), {"name": "Adam", "params": {"lr": 1e-3}},
        accum_steps=2)
    step, _ = mt.create_multitrack_timing_train_step(
        module, opt, scheduler=sched, use_amp=True, device="cpu")
    g = torch.Generator().manual_seed(0)
    before = {k: v.clone() for k, v in module.named_parameters()}
    assert np.isfinite(step(_batch(6, 1), g)["Loss"])
    assert all(torch.equal(v, before[k]) for k, v in
               module.named_parameters())
    assert np.isfinite(step(_batch(7, 1), g)["Loss"])
    assert not all(torch.equal(v, before[k]) for k, v in
                   module.named_parameters())


def main():
    """Print what the AMP arm's rule sees: for each timing model one JSON
    line of ``chip_smoke.amp_summary`` (without its per-tensor maps) of
    the SGD updates.

        JAX_PLATFORMS=cpu python -m tests.test_torch_timing_train
    """
    import json

    for name in MODELS:
        _, updates = _runs(_twins(name), use_amp=True)
        summary = chip_smoke.amp_summary(chip_smoke.judge_amp(
            *updates, AMP_RTOL, AMP_COS_MIN, AMP_L2_MAX))
        print(json.dumps({"model": name, **{
            k: v for k, v in summary.items()
            if k not in ("unresolved", "vanishes")}}))


if __name__ == "__main__":
    main()
