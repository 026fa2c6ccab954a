"""The postfilters' GAN discriminator and GAN step on the port against the
JAX package, on the CPU, at tiny widths: ``Conv2dD`` (``models/
discriminators.py``) and ``create_gan_train_step`` (``train/gan.py``).

* ``Conv2dD``'s feature maps and logits at MODULE_ATOL, with the shipped
  kernel (7, 3) under ``padding: [0, 0]`` (the maps shrink along T and D)
  and ``padding: null``; an input too short for the kernels gives XLA's
  empty maps.
* One and two GAN steps from the same weights, batches and noise (both
  packages' noise draws replayed by a function of the shape alone, as in
  ``tests/test_torch_postfilter.py``) for each ``gan_type`` and the knobs
  (``adv_streams``, ``mask_nth_mgc_for_adv_loss``, ``vuv_mask``, the loss
  weights), with mixed lengths: every metric at METRIC_RTOL of max(1,
  |value|) and every G and D weight at PARAM_ATOL after each step (float32
  on both sides; the hinge's ``Loss_Adv``, a mean of logits near zero,
  moves by 2e-5 of its value).  The
  vanilla GAN's discriminator ends in a sigmoid, as that loss reads its
  logits as probabilities.  A batch too short for a ``padding: [0, 0]``
  discriminator has NaN adversarial losses and finite gradients in both.
* ``use_amp``: G in bf16, D and the losses float32; the port's bf16 step
  against JAX's at AMP_RTOL (the two round G's activations in other
  orders: JAX adds the float32 noise image before its first conv and runs
  that conv in float32, the port in bf16).
* A NaN batch leaves both networks and their Adam state as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ensemble_svs_with_interactions_tpu.train import gan as jax_gan
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.models import postfilters
from ensemble_svs_with_interactions_tpu_torch.models.discriminators import (
    Conv2dD,
)
from ensemble_svs_with_interactions_tpu_torch.train import gan
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    build_optimizer,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_postfilter import _noise

MODULE_ATOL = 1e-5
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-5
AMP_RTOL = 2e-2
LR = 1e-3
SS = [16, 1, 1, 3]
B, T = 2, 128
PF = "ensemble_svs_with_interactions_tpu.models.postfilters"
D_TARGET = "ensemble_svs_with_interactions_tpu.models.discriminators.Conv2dD"
G_CONFIG = {
    "_target_": f"{PF}.MultistreamPostFilter", "stream_sizes": SS,
    "mgc_offset": 2, "bap_offset": 0, "lf0_postfilter": None,
    "mgc_postfilter": {"_target_": f"{PF}.Conv2dPostFilter", "channels": 4,
                       "kernel_size": [3, 3], "noise_type": "frame_wise",
                       "smoothing_width": 100},
    "bap_postfilter": {"_target_": f"{PF}.Conv2dPostFilter", "channels": 4,
                       "kernel_size": [3, 1], "noise_type": "bin_wise",
                       "smoothing_width": 5}}
ADAM = {"name": "Adam", "params": {"lr": LR}}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def same_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_noise(shape), dtype))
    monkeypatch.setattr(postfilters, "draw_noise",
                        lambda shape, generator: torch.from_numpy(
                            _noise(shape)))


def d_config(padding=(0, 0), channels=4, last_sigmoid=False):
    return {"_target_": D_TARGET, "in_dim": None, "channels": channels,
            "kernel_size": [7, 3],
            "padding": None if padding is None else list(padding),
            "last_sigmoid": last_sigmoid, "init_type": "kaiming_normal"}


# ------------------------------------------------------- select_streams


@pytest.mark.parametrize("streams", [[True, False, False, True],
                                     [False, True, True, False]])
def test_select_streams_is_jax_s(streams):
    """The adversarial input's stream selection, on NumPy arrays and torch
    tensors, bitwise JAX's."""
    from ensemble_svs_with_interactions_tpu.ops.multistream import (
        select_streams as jax_select,
    )
    from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
        select_streams,
    )

    x = np.random.default_rng(1).standard_normal((2, 5, sum(SS))).astype(
        np.float32)
    want = np.asarray(jax_select(x, SS, streams))
    np.testing.assert_array_equal(select_streams(x, SS, streams), want)
    np.testing.assert_array_equal(
        select_streams(torch.from_numpy(x), SS, streams).numpy(), want)


# ------------------------------------------------------------- Conv2dD


@pytest.mark.parametrize("padding", [(0, 0), None], ids=["valid", "same"])
@pytest.mark.parametrize("frames", [T, 32])
def test_conv2d_d_matches_jax(padding, frames):
    """Every feature map and the logits, in flax's NHWC layout; at 32
    frames ``padding: [0, 0]`` leaves the last maps empty, as XLA does."""
    cfg = d_config(padding, last_sigmoid=padding is None)
    module = init_module(instantiate(cfg), seed=2)
    x = np.random.default_rng(0).standard_normal((B, frames, 21)).astype(
        np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    want = jax_instantiate(cfg).apply(torch_to_flax(module), x)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=MODULE_ATOL)
    if padding is None:
        assert [g.shape[1] for g in got] == [frames, frames // 2,
                                             frames // 4, frames // 8,
                                             frames // 8]
        assert 0 <= float(got[-1].min()) <= float(got[-1].max()) <= 1
    elif frames == 32:
        assert got[3].shape[1] == got[4].shape[1] == 0
    else:
        assert [g.shape[1:3] for g in got] == [
            (122, 19), (58, 17), (26, 15), (10, 13), (4, 11)]


def test_conv2d_d_loads_jax_weights():
    """The JAX ``init``'s tree (traced, filled with seeded values) loads
    into the port's module, every leaf used."""
    cfg = d_config(None, channels=3)
    x = np.zeros((1, 32, 9), np.float32)
    tree = jax.eval_shape(lambda: jax_instantiate(cfg).init(
        jax.random.PRNGKey(2), x))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    module = flax_to_torch(instantiate(cfg), variables)
    assert isinstance(module, Conv2dD)
    assert module.Conv_2.weight.shape == (12, 6, 7, 3)


# ------------------------------------------------------------ GAN steps

CASES = {
    "lsgan": (d_config(), dict(gan_type="lsgan")),
    "vanilla": (d_config(None, last_sigmoid=True),
                dict(gan_type="vanilla-gan")),
    "hinge": (d_config(None), dict(gan_type="hinge")),
    "knobs": (d_config(), dict(
        gan_type="lsgan", stream_sizes=SS,
        adv_streams=[True, False, False, True], mask_nth_mgc_for_adv_loss=1,
        vuv_mask=True, adv_weight=0.5, fm_weight=3.0, recon_weight=2.0,
        clip_norm=5.0)),
}


def batch(seed, frames=T):
    """Targets with a V/UV stream voiced on part of the frames, degraded
    inputs, lengths T and T - 27."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((B, frames, sum(SS))).astype(np.float32)
    y[..., 17] = (rng.uniform(size=(B, frames)) > 0.3) * 2.0 - 1.0
    x = (y + 0.3 * rng.standard_normal(y.shape)).astype(np.float32)
    x[..., 17] = np.where(rng.uniform(size=(B, frames)) > 0.1, y[..., 17],
                          -y[..., 17])
    lengths = np.array([frames, frames - 27])
    for b in range(B):
        x[b, lengths[b]:] = y[b, lengths[b]:] = 0.0
    return {"in_feats": x, "out_feats": y, "lengths": lengths}


def port_step(dcfg, kw, use_amp=False):
    netG = init_module(instantiate(G_CONFIG), seed=0)
    netD = init_module(instantiate(dcfg), seed=2)
    optG, _ = build_optimizer(netG.parameters(), ADAM)
    optD, _ = build_optimizer(netD.parameters(), ADAM)
    step = gan.create_gan_train_step(netG, netD, optG, optD,
                                     use_amp=use_amp, device="cpu", **kw)
    return step, netG, netD


def jax_step(dcfg, kw, netG, netD, use_amp=False):
    tx = optax.adam(LR)
    step = jax_gan.create_gan_train_step(
        jax_instantiate(G_CONFIG), jax_instantiate(dcfg), tx, tx,
        use_amp=use_amp, **kw)
    pG, pD = torch_to_flax(netG)["params"], torch_to_flax(netD)["params"]
    state = {"paramsG": pG, "paramsD": pD, "optG_state": tx.init(pG),
             "optD_state": tx.init(pD), "step": 0}
    return step, state


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def run_both(dcfg, kw, batches, use_amp=False):
    """[(port metrics, JAX metrics, port G and D params, JAX state)] after
    each batch."""
    step, netG, netD = port_step(dcfg, kw, use_amp)
    jstep, state = jax_step(dcfg, kw, netG, netD, use_amp)
    out = []
    for i, b in enumerate(batches):
        got = {k: float(v) for k, v in step(
            _tensors(b), torch.Generator().manual_seed(i)).items()}
        state, ref = jstep(state, b, jax.random.PRNGKey(i))
        # the step donates its state: keep a copy of each
        out.append((got, {k: float(v) for k, v in ref.items()},
                    torch_to_flax(netG)["params"],
                    torch_to_flax(netD)["params"],
                    jax.tree_util.tree_map(np.array, state)))
    return out


def assert_params(got, want, atol):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(p))


@pytest.fixture(scope="module", params=sorted(CASES))
def two_steps(request):
    dcfg, kw = CASES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape,
                   dtype=jnp.float32: jnp.asarray(_noise(shape), dtype))
        mp.setattr(postfilters, "draw_noise", lambda shape, generator:
                   torch.from_numpy(_noise(shape)))
        return request.param, run_both(dcfg, kw, [batch(1), batch(2)])


@pytest.mark.parametrize("n", [1, 2])
def test_gan_steps_match_jax(two_steps, n):
    """After step n: the metrics (JAX's names) and every G and D
    weight."""
    _, steps = two_steps
    got, ref, pG, pD, state = steps[n - 1]
    assert list(got) == list(gan.METRIC_KEYS)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL,
                                   atol=METRIC_RTOL, err_msg=k)
    assert_params(pG, state["paramsG"], PARAM_ATOL)
    assert_params(pD, state["paramsD"], PARAM_ATOL)
    assert int(state["step"]) == n


def test_short_batch_has_nan_adversarial_losses_as_jax():
    """32 frames under ``padding: [0, 0]``: the logit map is empty, its
    means NaN in both packages, the gradients finite, so both steps
    update."""
    dcfg, kw = CASES["lsgan"]
    steps = run_both(dcfg, kw, [batch(3, frames=32)])
    got, ref, pG, pD, state = steps[0]
    for k in ("Loss_Adv", "Loss_D", "Loss_G"):
        assert np.isnan(got[k]) and np.isnan(ref[k]), k
    for k in ("Loss_Recon", "GradNorm_G", "GradNorm_D"):
        np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL,
                                   err_msg=k)
    assert_params(pG, state["paramsG"], PARAM_ATOL)
    assert_params(pD, state["paramsD"], PARAM_ATOL)


def test_amp_step_matches_jax():
    """``use_amp``: G's forward in bf16, its float32 masters updated; D
    and the losses float32."""
    dcfg, kw = CASES["lsgan"]
    steps = run_both(dcfg, kw, [batch(1)], use_amp=True)
    got, ref, pG, pD, state = steps[0]
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=AMP_RTOL, err_msg=k)
    for tree in (pG, pD):
        assert all(a.dtype == np.float32
                   for a in jax.tree_util.tree_leaves(tree))
    assert_params(pD, state["paramsD"], 2 * LR)
    assert_params(pG, state["paramsG"], 2 * LR)


def _snapshot(module, opt):
    return ([t.detach().clone() for t in module.parameters()],
            {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in opt.state.items()})


def _same(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and a[1].keys() == b[1].keys()
            and all(torch.equal(a[1][k][n], b[1][k][n])
                    for k in a[1] for n in a[1][k]))


def test_nan_batch_leaves_both_networks():
    """A NaN target: both gradient norms non-finite, both networks and
    their Adam state unchanged; the step still counts."""
    step, netG, netD = port_step(*CASES["lsgan"])
    optG, optD = step.optimizers
    step(_tensors(batch(1)), torch.Generator())
    before = [_snapshot(netG, optG), _snapshot(netD, optD)]
    bad = batch(2)
    bad["out_feats"][0, 5, 4] = np.nan  # a dim the mgc postfilter sees
    m = step(_tensors(bad), torch.Generator())
    assert not np.isfinite(float(m["GradNorm_G"]))
    assert not np.isfinite(float(m["GradNorm_D"]))
    assert _same(before[0], _snapshot(netG, optG))
    assert _same(before[1], _snapshot(netD, optD))
    assert step.state["step"] == 2


def test_unknown_gan_type_and_vuv_mask_without_streams_raise():
    netG, netD = instantiate(G_CONFIG), instantiate(d_config())
    opt, _ = build_optimizer(netG.parameters(), ADAM)
    with pytest.raises(ValueError, match="Unknown gan type"):
        gan.create_gan_train_step(netG, netD, opt, opt, gan_type="wgan",
                                  device="cpu")
    with pytest.raises(ValueError, match="vuv_mask"):
        gan.create_gan_train_step(netG, netD, opt, opt, vuv_mask=True,
                                  device="cpu")
