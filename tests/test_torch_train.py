"""The port's training slice against the JAX package at tiny dims: the
flagship model's training forward, the losses, the multitrack train step,
the optimizers and schedules, and the NaN-skip.

Weights are carried across with ``flax_to_torch``; inputs come from numpy
seeds.  Dropout masks cannot match across frameworks, so the tiny flagship
(``__graft_entry__._flagship_netg()``) runs with every dropout at 0 and
zoneout 0.  Tolerances: outputs, batch statistics and parameters after one
SGD step at atol 1e-5, metrics at rtol 1e-5 (float32 on both sides with
other summation orders); optimizer updates at atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from ensemble_svs_with_interactions_tpu.ops.mdn import mdn_loss as jax_mdn_loss
from ensemble_svs_with_interactions_tpu.train import losses as JL
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import multitrack as jax_mt
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import mdn_loss
from ensemble_svs_with_interactions_tpu_torch.train import losses as L
from ensemble_svs_with_interactions_tpu_torch.train import loop
from ensemble_svs_with_interactions_tpu_torch.train import multitrack as mt
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_svs import run_cached
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ATOL = 1e-5
RTOL = 1e-5
B, T = 2, 30
SS = ge.STREAM_SIZES
METRICS = ("Loss", "Loss_Feats", "Loss_Pitch", "Loss_LogF0_Interaction",
           "Loss_MGC-0th_Interaction")


def _t(a):
    return torch.from_numpy(np.array(a))


def _config():
    cfg = ge._flagship_netg()
    cfg["lf0_model"].update(zoneout=0.0, prenet_dropout=0.0)
    return cfg


def _batch(seed=0):
    """A batch with mixed lengths whose vuv streams are voiced on part of
    the frames of each track, so the both-voiced mask is non-trivial."""
    rng = np.random.default_rng(seed)
    out_dim = sum(SS)
    return {
        "in_feats0": rng.uniform(0, 1, (B, T, 86)).astype(np.float32),
        "in_feats1": rng.uniform(0, 1, (B, T, 86)).astype(np.float32),
        "out_feats0": rng.normal(size=(B, T, out_dim)).astype(np.float32),
        "out_feats1": rng.normal(size=(B, T, out_dim)).astype(np.float32),
        "spks0": np.array([0, 1], np.int32),
        "spks1": np.array([1, 2], np.int32),
        "lengths": np.array([T, 22], np.int32),
    }


def _flagship():
    """(config, JAX module, flax variables) of the tiny flagship."""
    cfg = _config()
    jm = jax_instantiate(cfg)
    b = _batch()
    args = (jnp.asarray(b["in_feats0"]), jnp.asarray(b["in_feats1"]),
            (jnp.asarray(b["spks0"]), jnp.asarray(b["spks1"])),
            jnp.asarray(b["lengths"]),
            (jnp.asarray(b["out_feats0"]), jnp.asarray(b["out_feats1"])))
    variables = run_cached("tiny_flagship_variables", lambda: (
        jax.tree_util.tree_map(np.asarray, jm.init(
            {k: jax.random.PRNGKey(i) for i, k in
             enumerate(("params", "dropout", "prenet", "zoneout"))},
            *args, train=True))))
    return cfg, jm, variables


@pytest.fixture(scope="module")
def flagship():
    return _flagship()


def _rngs():
    return {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("dropout", "prenet", "zoneout"))}


def _assert_state_matches(port, cfg, variables):
    """Every parameter and running statistic of ``port`` against the flax
    ``variables`` carried into a fresh port module."""
    ref = flax_to_torch(instantiate(cfg), variables).state_dict()
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), ref[k].numpy(),
                                   atol=ATOL, err_msg=k)


def test_flagship_train_forward_matches_jax(flagship):
    """Both tracks, teacher-forced, with masked batch statistics: outputs
    ((out_m, lf0_res_m), (out_s, lf0_res_s)) and the updated running
    statistics against ``apply(..., mutable=["batch_stats"])``."""
    cfg, jm, variables = flagship
    b = _batch(1)
    jargs = (jnp.asarray(b["in_feats0"]), jnp.asarray(b["in_feats1"]),
             (jnp.asarray(b["spks0"]), jnp.asarray(b["spks1"])),
             jnp.asarray(b["lengths"]),
             (jnp.asarray(b["out_feats0"]), jnp.asarray(b["out_feats1"])))
    ref, updates = jm.apply(variables, *jargs, train=True, rngs=_rngs(),
                            mutable=["batch_stats"])
    port = flax_to_torch(instantiate(cfg), variables)
    with torch.no_grad():
        got = port(_t(b["in_feats0"]), _t(b["in_feats1"]),
                   (_t(b["spks0"]).long(), _t(b["spks1"]).long()),
                   _t(b["lengths"]).long(),
                   (_t(b["out_feats0"]), _t(b["out_feats1"])), train=True)
    (om, rm), (os_, rs) = got
    assert om.shape == (B, T, sum(SS)) and rm.shape == (B, T, 1)
    for g, r in zip((om, rm, os_, rs), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    _assert_state_matches(port, cfg, {"params": variables["params"],
                                      "batch_stats": updates["batch_stats"]})


# -------------------------------------------------------------------- losses
def _loss_inputs(seed=2):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, T, sum(SS))).astype(np.float32)
    target = rng.normal(size=(B, T, sum(SS))).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 17])[:, None]).astype(
        np.float32)[:, :, None]
    return pred, target, mask


@pytest.mark.parametrize("kind", ["mse", "l1"])
def test_masked_criteria_match_jax(kind):
    pred, target, mask = _loss_inputs()
    np.testing.assert_allclose(
        L.feats_criterion(_t(pred), _t(target), _t(mask), kind).item(),
        float(JL.feats_criterion(pred, target, mask, kind)), rtol=RTOL)
    np.testing.assert_allclose(
        L.masked_mean(_t(pred), _t(mask)).item(),
        float(JL.masked_mean(pred, mask)), rtol=RTOL)
    dyn = np.random.default_rng(3).uniform(size=(B, T, 1)).astype(np.float32)
    res = pred[..., :1]
    np.testing.assert_allclose(
        L.pitch_regularization_loss(_t(res), _t(mask), _t(dyn)).item(),
        float(JL.pitch_regularization_loss(res, mask, dyn)), rtol=RTOL)
    np.testing.assert_allclose(
        L.pitch_regularization_loss([_t(res), _t(pred[..., 1:2])],
                                    _t(mask)).item(),
        float(JL.pitch_regularization_loss([res, pred[..., 1:2]], mask)),
        rtol=RTOL)


@pytest.mark.parametrize("form", ["arrays", "postnet", "mdn", "diffusion",
                                  "stream_wise"])
def test_multistream_loss_matches_jax(form):
    pred, target, mask = _loss_inputs(4)
    rng = np.random.default_rng(5)
    streams = [pred[..., a: a + s] for a, s in
               zip(np.cumsum([0] + SS[:-1]), SS)]
    if form == "postnet":
        streams[0] = [streams[0], streams[0] * 0.5]
    elif form == "mdn":
        G = 2
        log_pi = np.log(rng.dirichlet(np.ones(G), size=(B, T))).astype(
            np.float32)
        streams[1] = (log_pi,
                      rng.normal(0, 0.3, (B, T, G, 1)).astype(np.float32),
                      rng.normal(size=(B, T, G, 1)).astype(np.float32))
    elif form == "diffusion":
        streams[3] = (streams[3], rng.normal(size=streams[3].shape).astype(
            np.float32))

    def port_form(s):
        if isinstance(s, list):
            return [_t(a) for a in s]
        if isinstance(s, tuple):
            return tuple(_t(a) for a in s)
        return _t(s)

    sw = form == "stream_wise"
    got = L.multistream_loss([port_form(s) for s in streams], _t(target),
                             _t(mask), SS, stream_wise=sw)
    ref = JL.multistream_loss(streams, target, mask, SS, stream_wise=sw)
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)


def test_mdn_loss_and_refinement_list_match_jax():
    rng = np.random.default_rng(6)
    G, D = 3, 2
    for log_pi_shape in ((B, T, G), (B, T, G, D)):
        log_pi = np.log(rng.dirichlet(np.ones(G), size=log_pi_shape[:2]
                                      + log_pi_shape[3:]))
        log_pi = np.moveaxis(log_pi, -1, 2).astype(np.float32)
        args = (log_pi, rng.normal(0, 0.5, (B, T, G, D)).astype(np.float32),
                rng.normal(size=(B, T, G, D)).astype(np.float32),
                rng.normal(size=(B, T, D)).astype(np.float32))
        for reduce in (True, False):
            np.testing.assert_allclose(
                mdn_loss(*[_t(a) for a in args], reduce=reduce).numpy(),
                np.asarray(jax_mdn_loss(*args, reduce=reduce)), rtol=RTOL,
                atol=1e-6)
    full = np.zeros((B, T, sum(SS)), np.float32)
    per_stream = [np.zeros((B, T, s), np.float32) for s in SS]
    for p in ([full, full], per_stream, full, [full, per_stream[0]]):
        port = ([_t(a) for a in p] if isinstance(p, list) else _t(p))
        assert L.is_refinement_list(port, SS) == JL.is_refinement_list(p, SS)


@pytest.mark.parametrize("sub_require_grad", [True, False])
def test_multitrack_loss_both_voiced_mask_and_sub_detach(sub_require_grad):
    """The lf0 interaction counts only frames voiced in both tracks; with
    ``sub_require_grad=False`` no gradient reaches the sub track."""
    pred_m, out_m, mask = _loss_inputs(7)
    pred_s, out_s, _ = _loss_inputs(8)
    got_inputs = [_t(a) for a in (pred_m, pred_s, out_m, out_s, mask)]
    got_inputs[0].requires_grad_(True)
    got_inputs[1].requires_grad_(True)
    got = mt.multitrack_acoustic_loss(*got_inputs, SS,
                                      sub_require_grad=sub_require_grad)
    ref = jax_mt.multitrack_acoustic_loss(
        pred_m, pred_s, out_m, out_s, mask, SS,
        sub_require_grad=sub_require_grad)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=RTOL, atol=1e-7)
    assert got[2].item() == 0.0  # hybrid models: no mgc-0 interaction
    # the interaction over the both-voiced frames, written out
    lf0 = sum(SS[:1])
    vuv = lf0 + 1
    both = ((out_m[..., vuv] > 0) & (out_s[..., vuv] > 0)) * mask[..., 0]
    err = ((pred_m[..., lf0] - pred_s[..., lf0])
           - (out_m[..., lf0] - out_s[..., lf0])) ** 2
    assert 0 < both.sum() < mask.sum()
    np.testing.assert_allclose(got[1].item(),
                               (err * both).sum() / both.sum(), rtol=RTOL)
    got[1].backward()
    assert (got_inputs[1].grad is not None
            and got_inputs[1].grad.abs().sum() > 0) == sub_require_grad


def test_interaction_weight_matches_jax():
    for spec in ("exponential", 0.5, None):
        assert mt.interaction_weight(spec, 3, 20) == \
            jax_mt.interaction_weight(spec, 3, 20)


# ---------------------------------------------------------------- train step
def _jax_weights():
    return {"logf0_diff": jnp.asarray(1.0), "mgc_diff": jnp.asarray(1.0)}


def _port_step(cfg, variables, opt_cfg, **kw):
    module = flax_to_torch(instantiate(cfg), variables)
    opt, sched = loop.build_optimizer(module.parameters(), opt_cfg)
    steps = mt.create_multitrack_acoustic_train_step(
        module, opt, {"stream_sizes": SS}, scheduler=sched,
        pitch_reg_weight=1.0, device="cpu", **kw)
    return module, opt, steps


def test_train_step_sgd_matches_jax(flagship):
    """One SGD step (the update is linear in the clipped gradient): the
    metrics, the new parameters and the new running statistics."""
    cfg, jm, variables = flagship
    opt_cfg = {"name": "SGD", "params": {"lr": 0.5}}
    tx = jax_loop.build_optimizer(opt_cfg)
    jstep, _ = jax_mt.create_multitrack_acoustic_train_step(
        jm, tx, {"stream_sizes": SS}, pitch_reg_weight=1.0, donate=False)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"]),
             "step": jnp.asarray(0)}
    batch = _batch(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, ref = jstep(state, jbatch, _jax_weights(),
                           jax.random.PRNGKey(0))

    module, _, (step, eval_step) = _port_step(cfg, variables, opt_cfg)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    got_eval, pred = eval_step(batch, {"logf0_diff": 1.0, "mgc_diff": 1.0})
    assert pred.shape == (B, T, sum(SS))
    assert all(np.isfinite(v) for v in got_eval.values())
    for k, v in module.state_dict().items():  # evaluation changes nothing
        assert torch.equal(v, before[k]), k
    got = step(batch, {"logf0_diff": 1.0, "mgc_diff": 1.0},
               torch.Generator().manual_seed(0))
    for k in METRICS + ("GradNorm",):
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    assert got["GradNorm"] > 1.0  # the clip was active
    _assert_state_matches(module, cfg,
                          {"params": new_state["params"],
                           "batch_stats": new_state["batch_stats"]})


def test_nan_loss_skips_the_update(flagship):
    """A non-finite loss leaves the parameters and the optimizer state as
    they were (one finite step first, so the Adam state exists)."""
    cfg, _, variables = flagship
    module, opt, (step, _) = _port_step(
        cfg, variables, {"name": "Adam", "params": {"lr": 1e-3}})
    weights = {"logf0_diff": 1.0, "mgc_diff": 1.0}
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(step(_batch(4), weights, g)["Loss"])
    params = {k: v.clone() for k, v in module.named_parameters()}
    opt_state = {k: {n: t.clone() for n, t in s.items()}
                 for k, s in opt.state.items()}
    bad = _batch(5)
    bad["out_feats0"][0, 3, 0] = np.nan
    metrics = step(bad, weights, g)
    assert not np.isfinite(metrics["Loss"])
    for k, v in module.named_parameters():
        assert torch.equal(v, params[k]), k
    for k, s in opt.state.items():
        for n, t in s.items():
            assert torch.equal(t, opt_state[k][n]), n


# ------------------------------------------------- optimizers and schedules
@pytest.mark.parametrize("opt_cfg", [
    {"name": "Adam", "params": {"lr": 1e-2}},
    {"name": "Adam", "params": {"lr": 1e-2, "weight_decay": 0.1}},
    {"name": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.05,
                                 "betas": [0.8, 0.99]}},
    {"name": "SGD", "params": {"lr": 0.1}},
    {"name": "SGD", "params": {"lr": 0.1, "momentum": 0.9}},
    {"name": "RAdam", "params": {"lr": 1e-2}},
], ids=["adam", "adam_wd_is_adamw", "adamw", "sgd", "sgd_momentum", "radam"])
def test_optimizer_matches_optax(opt_cfg):
    """The same gradients for 3 steps, under a StepLR schedule that
    changes the rate after the second step."""
    sched_cfg = {"name": "StepLR", "params": {"step_size": 2, "gamma": 0.5}}
    rng = np.random.default_rng(9)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = jax_loop.build_optimizer(opt_cfg, sched_cfg)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt, sched = loop.build_optimizer(tparams.values(), opt_cfg, sched_cfg)
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = _t(g[k])
        opt.step()
        sched.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("sched_cfg", [
    None,
    {"name": "StepLR", "params": {"step_size": 3, "gamma": 0.5}},
    {"name": "ExponentialLR", "params": {"gamma": 0.9}},
    {"name": "CosineAnnealingLR", "params": {"T_max": 20}},
    {"name": "NoamLR", "params": {"warmup_steps": 8}},
], ids=["constant", "steplr", "exponentiallr", "cosine", "noam"])
def test_lr_schedule_matches_optax(sched_cfg):
    opt_cfg = {"name": "Adam", "params": {"lr": 2e-3}}
    ref = jax_loop.build_lr_schedule(opt_cfg, sched_cfg, steps_per_epoch=2)
    got = loop.build_lr_schedule(opt_cfg, sched_cfg, steps_per_epoch=2)
    for step in (0, 1, 2, 5, 8, 9, 17, 40, 100):
        # optax evaluates in float32: rtol 1e-5 covers gamma ** 50
        want = float(ref(jnp.asarray(step))) if callable(ref) else ref
        np.testing.assert_allclose(got(step), want, rtol=1e-5,
                                   err_msg=str(step))
