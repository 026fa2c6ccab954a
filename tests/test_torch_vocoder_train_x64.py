"""The vocoder GAN step in float64 on both sides: the port against the JAX
package's step under ``jax.enable_x64``, from the same weights and batch.

``tests/test_torch_vocoder_train.py`` holds the float32 steps with two
wider judges (``GradNorm_G`` at 1e-3, 1 in 500 weights allowed past 1e-5)
for float32 conditioning.  Here each family's step (hn-uSFGAN with the
log-mel and residual source losses, SiFiGAN with feature matching, PWG
with the multi-resolution STFT loss) runs in float64 in both packages:
every metric, ``GradNorm_G`` among them, and every updated weight and
Adam moment agree within 1e-10, so the float32 judges hide no difference
of function between the two steps.
"""

import jax
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models.vocoders import (
    cheaptrick as jct,
)
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import vocoder as jvoc
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.train import (
    vocoder_trainer as trainer,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_vocoder_train import FAMILIES, HOP, SR, batch, config

RTOL = 1e-10
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_step64(cfg, gen, dis):
    """The JAX trainer's step as ``test_torch_vocoder_train.jax_step``
    builds it (the source loss's mel filterbank rounded to float32, as
    the JAX trainer passes it and the port stores it), and its start
    state from the port's float64 weights; call under x64."""
    t = cfg.train
    jgen = jax_instantiate(cfg.model.generator)
    jdis = jax_instantiate(cfg.model.discriminator)
    optG = jax_loop.build_optimizer(dict(t.optim.netG.optimizer))
    optD = jax_loop.build_optimizer(dict(t.optim.netD.optimizer))
    src = dict(t.get("source_loss", {}) or {})
    layer = fb = None
    if float(t.get("lambda_source", 0.0)) > 0:
        from ensemble_svs_with_interactions_tpu.data.data_source import (
            mel_filterbank,
        )

        layer = jct.CheapTrickLayer(SR, HOP, src["fft_size"],
                                    src["f0_floor"], src["f0_ceil"])
        fb = np.asarray(mel_filterbank(SR, src["fft_size"], src["n_mels"],
                                       0, None), np.float32)
    step = jvoc.create_vocoder_gan_train_step(
        jgen, jdis, optG, optD, stft_weight=float(t.lambda_stft),
        adv_weight=float(t.lambda_adv),
        fm_weight=float(t.get("lambda_feat_match", 0.0)),
        fft_sizes=tuple(t.get("fft_sizes", [1024, 2048, 512])),
        hop_sizes=tuple(t.get("hop_sizes", [120, 240, 50])),
        win_lengths=tuple(t.get("win_lengths", [600, 1200, 240])),
        stft_loss_type="mel" if "stft_loss" in t else "multi_resolution",
        mel_loss_params=dict(t.get("stft_loss", {}) or {}),
        source_weight=float(t.get("lambda_source", 0.0)),
        cheaptrick_layer=layer, source_mel_fb=fb)
    pG, pD = torch_to_flax(gen)["params"], torch_to_flax(dis)["params"]
    state = {"paramsG": pG, "paramsD": pD, "optG_state": optG.init(pG),
             "optD_state": optD.init(pD), "step": 0}
    return step, state


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def steps64(request):
    """STEPS float64 steps of one family in both packages: (family, port
    metrics, JAX metrics, port G, port D, port step, JAX state)."""
    cfg = config(request.param)
    torch.manual_seed(0)
    gen = trainer.build_generator(cfg).double()
    dis = instantiate(cfg.model.discriminator).double()
    step = trainer.gan_step(cfg, gen, dis, "cpu")
    got, ref = [], []
    with jax.enable_x64(True):
        jstep, state = jax_step64(cfg, gen, dis)
        assert all(v.dtype == np.float64 for _, v in _leaves(
            state["paramsG"]))
        for i in range(STEPS):
            b = {k: v.astype(np.float64)
                 for k, v in batch(cfg.model.signal_types, 10 + i).items()}
            got.append({k: float(v) for k, v in step(
                {k: torch.from_numpy(v) for k, v in b.items()}).items()})
            state, m = jstep(state, b)
            ref.append({k: float(v) for k, v in m.items()})
        state = jax.tree_util.tree_map(np.asarray, state)
    return request.param, got, ref, gen, dis, step, state


def test_float64_metrics_match_jax(steps64):
    """Every metric of every step, ``GradNorm_G`` and ``GradNorm_D``
    included, within 1e-10 relative."""
    _, got, ref, *_ = steps64
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=RTOL, atol=1e-14,
                                       err_msg=k)
        assert np.isfinite(g["GradNorm_G"]) and g["GradNorm_G"] > 0


@pytest.mark.parametrize("net", ("G", "D"))
def test_float64_weights_and_moments_match_jax(steps64, net):
    """The weights after the steps and Adam's first and second moments,
    each leaf within 1e-10 of its largest entry."""
    _, _, _, gen, dis, step, state = steps64
    module, opt = (gen, step.optimizers[0]) if net == "G" else (
        dis, step.optimizers[1])
    got = _leaves(torch_to_flax(module)["params"])
    want = _leaves(state[f"params{net}"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float64, path
        assert _rel(g, w) <= RTOL, (path, _rel(g, w))
    adam = trainer.adam_state(module, opt)["0"]
    jadam = state[f"opt{net}_state"][0]
    assert int(adam["count"]) == int(jadam.count) == STEPS
    for key, jkey in (("mu", "mu"), ("nu", "nu")):
        for (path, g), (_, w) in zip(_leaves(adam[key]),
                                     _leaves(getattr(jadam, jkey))):
            assert _rel(g, w) <= RTOL, (net, key, path, _rel(g, w))
