"""The model zoo's remaining names and two shipped configs that no other
port test builds from its file, on the CPU against the JAX package.

* ``models`` exports JAX's five names (``BaseModel``, ``PredictionType``,
  ``LSTM``, ``Conv2dPostFilter``, ``MultistreamPostFilter``), and
  ``BaseModel.preprocess_target`` is the identity; the shallow-AR models
  keep their own.
* ``configs/postfilter/postfilter_sp.yaml`` read by each package's YAML
  reader and built by each: the ``MultistreamPostFilter`` (streams [1025,
  1, 1, 5], ``mgc_offset: 10``, a 64-channel 7 x 7 ``Conv2dPostFilter``
  with bin-wise noise) and its ``Conv2dD``, at the shipped widths.  JAX's
  initial weights carried into the port by ``flax_port.flax_to_torch``;
  the inference forward at MODULE_ATOL and one GAN step of the port's
  postfilter trainer (``train/postfilter_trainer.gan_step``) against
  JAX's ``create_gan_train_step``, the metrics at ``tests/
  test_torch_gan.py``'s tolerance, the weights by ``tests/
  test_torch_vocoder_train.py``'s Adam judge (``assert_adam_weights``),
  both packages' noise replayed by a function of the shape.
* ``configs/vocoder/vocoder_hifigan.yaml`` read and built the same way:
  ``HiFiGANGenerator`` (the shipped 512 channels, upsampling 5 x 4 x 4 x 3)
  and ``HiFiGANMultiScaleMultiPeriodDiscriminator`` at the shipped widths;
  the generator forward at GEN_RTOL of its peak, and one
  ``bin/train_vocoder`` GAN step (``train/vocoder_trainer.gan_step``)
  against JAX's step on one crop of VOC_FRAMES frames: the two float64
  steps (JAX's under x64) within F64_RTOL, then the float32 metrics at
  ``tests/test_torch_vocoder_train.py``'s tolerances and the gradients
  as ``chip_smoke.hold_gan_step`` judges them, with the float64 step as
  the oracle.
"""

import copy
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu import models as jax_models
from ensemble_svs_with_interactions_tpu.train import gan as jax_gan
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
    load_config as jax_load_config,
)
from ensemble_svs_with_interactions_tpu_torch import models
from ensemble_svs_with_interactions_tpu_torch.base import BaseModel
from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe
from ensemble_svs_with_interactions_tpu_torch.models import postfilters
from ensemble_svs_with_interactions_tpu_torch.train import (
    postfilter_trainer,
    vocoder_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    _wrap,
    instantiate,
    load_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_svs import few_threads  # noqa: F401
from tests.test_torch_vocoder_train import (
    GRADNORM_RTOL,
    METRIC_RTOL as VOC_METRIC_RTOL,
    PARAM_ATOL,
    PARAM_FAR_SHARE,
    jax_step as jax_vocoder_step,
)

MODULE_ATOL = 1e-5
PF_METRIC_RTOL = 1e-5
GEN_RTOL = 1e-5
HEADROOM = chip_smoke.VOCODER_HEADROOM
F64_RTOL = chip_smoke.VOCODER_F64_RTOL
PF_B, PF_T = 1, 16
VOC_FRAMES = 12
PF_FILE = chip_smoke.CONFIGS / "postfilter" / "postfilter_sp.yaml"
VOC_FILE = chip_smoke.CONFIGS / "vocoder" / "vocoder_hifigan.yaml"
FIVE = ("BaseModel", "PredictionType", "LSTM", "Conv2dPostFilter",
        "MultistreamPostFilter")


def _noise(shape):
    """Standard normal noise, a function of the shape alone."""
    shape = tuple(int(s) for s in shape)
    seed = zlib.crc32(repr(shape).encode())
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(autouse=True)
def same_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_noise(shape), dtype))
    monkeypatch.setattr(postfilters, "draw_noise",
                        lambda shape, generator: torch.from_numpy(
                            _noise(shape)))


@pytest.mark.parametrize("name", FIVE)
def test_models_exports_jax_s_names(name):
    port, ref = getattr(models, name), getattr(jax_models, name)
    assert port.__name__ == ref.__name__
    if name == "PredictionType":
        assert [(m.name, m.value) for m in port] == [
            (m.name, m.value) for m in ref]


def test_preprocess_target_is_the_identity_but_for_shallow_ar():
    y = torch.randn(2, 5, 3)
    for m in (models.FFN(in_dim=3, hidden_dim=4, out_dim=3),
              models.MDN(in_dim=3, hidden_dim=4, out_dim=3)):
        assert isinstance(m, BaseModel) and m.preprocess_target(y) is y
    sar = models.LSTMRNNSAR(in_dim=3, hidden_dim=4, out_dim=3,
                            stream_sizes=[3], ar_orders=[2])
    assert type(sar).preprocess_target is not BaseModel.preprocess_target


def assert_adam_weights(module, jax_params, lr):
    """Every weight after one Adam step within 2 lr of JAX's, all but
    PARAM_FAR_SHARE of them within PARAM_ATOL: Adam divides each gradient
    element by its own RMS, so a weight whose gradient is float noise
    moves by up to lr either way (``tests/test_torch_vocoder_train.py``'s
    judge; at the shipped widths the postfilter's 404,544-weight middle
    convolution has such a weight)."""
    got = jax.tree_util.tree_leaves_with_path(torch_to_flax(module)["params"])
    want = jax.tree_util.tree_leaves_with_path(jax_params)
    assert [p for p, _ in got] == [p for p, _ in want]
    diff = np.concatenate([np.abs(a - np.asarray(b)).ravel()
                           for (_, a), (_, b) in zip(got, want)])
    assert diff.max() <= 2 * lr, diff.max()
    assert (diff > PARAM_ATOL).mean() <= PARAM_FAR_SHARE, np.sort(diff)[-5:]


def _files(path):
    """(the port's config, JAX's) of one shipped file, each read by its
    own package."""
    return load_config(path), jax_load_config(str(path))


# ------------------------------------------------------- postfilter_sp


def pf_batch(seed):
    """Targets with a V/UV stream voiced on most frames, degraded inputs,
    over the sp streams."""
    rng = np.random.default_rng(seed)
    D = 1025 + 1 + 1 + 5
    y = (0.5 * rng.standard_normal((PF_B, PF_T, D))).astype(np.float32)
    y[..., 1026] = (rng.uniform(size=(PF_B, PF_T)) > 0.2) * 2.0 - 1.0
    x = (y + 0.3 * rng.standard_normal(y.shape)).astype(np.float32)
    x[..., 1026] = y[..., 1026]
    return {"in_feats": x, "out_feats": y,
            "lengths": np.array([PF_T] * PF_B)}


@pytest.fixture(scope="module")
def pf_twins():
    """postfilter_sp.yaml's G and D in both packages, JAX's initial
    weights carried into the port; (port cfg, JAX G, JAX D, port G, port
    D, JAX G variables, JAX D variables)."""
    cfg, jcfg = _files(PF_FILE)
    assert cfg == jcfg
    x = np.zeros((2, 32, sum(cfg["stream_sizes"])), np.float32)
    jG, jD = jax_instantiate(jcfg["netG"]), jax_instantiate(jcfg["netD"])
    vG = jG.init({"params": jax.random.PRNGKey(0),
                  "noise": jax.random.PRNGKey(1)}, x)
    vD = jD.init(jax.random.PRNGKey(2), x)
    vG, vD = (jax.tree_util.tree_map(np.array, v) for v in (vG, vD))
    G, D = instantiate(cfg["netG"]), instantiate(cfg["netD"])
    flax_to_torch(G, vG)
    flax_to_torch(D, vD)
    return cfg, jG, jD, G, D, vG, vD


def test_postfilter_sp_is_built_from_its_file(pf_twins):
    cfg, _, _, G, D, vG, _ = pf_twins
    assert isinstance(G, models.MultistreamPostFilter)
    assert G.mgc_offset == 10 and list(G.stream_sizes) == [1025, 1, 1, 5]
    conv = G.mgc_postfilter
    assert isinstance(conv, models.Conv2dPostFilter)
    assert conv.conv1.out_channels == 64
    assert tuple(conv.conv1.kernel_size) == (7, 7)
    assert conv.noise_type == "bin_wise"
    assert G.bap_postfilter is None and G.lf0_postfilter is None
    assert type(D).__name__ == "Conv2dD"
    got = torch_to_flax(G)["params"]
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(
                                  vG["params"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_postfilter_sp_forward_matches_jax(pf_twins):
    _, jG, _, G, _, vG, _ = pf_twins
    x = pf_batch(0)["in_feats"]
    ref = np.asarray(jG.apply(vG, jnp.asarray(x), method="inference"))
    with torch.no_grad():
        got = G.inference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODULE_ATOL)
    np.testing.assert_array_equal(got[..., :10], x[..., :10])
    np.testing.assert_array_equal(got[..., 1025:], x[..., 1025:])
    assert not np.allclose(got[..., 10:1025], x[..., 10:1025])


def test_postfilter_sp_gan_step_matches_jax(pf_twins, tmp_path):
    """One step of stage 9's GAN (the recipe's trainer config around the
    shipped model) in both packages from the same weights, batch and
    noise: the metrics and every weight after the step."""
    cfg, jG, jD, G, D, vG, vD = pf_twins
    train_cfg = run_recipe.postfilter_train_config(
        _wrap({"postfilter": {"model": cfg}}), tmp_path)
    step = postfilter_trainer.gan_step(train_cfg, G, D, "cpu")
    tx = optax.adam(1e-4)
    jstep = jax_gan.create_gan_train_step(
        jG, jD, tx, tx, stream_sizes=list(cfg["stream_sizes"]))
    state = {"paramsG": vG["params"], "paramsD": vD["params"],
             "optG_state": tx.init(vG["params"]),
             "optD_state": tx.init(vD["params"]), "step": 0}
    b = pf_batch(1)
    got = {k: float(v) for k, v in step(
        {k: torch.from_numpy(v) for k, v in b.items()},
        torch.Generator().manual_seed(0)).items()}
    state, ref = jstep(state, b, jax.random.PRNGKey(0))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], float(v), rtol=PF_METRIC_RTOL,
                                   atol=PF_METRIC_RTOL, err_msg=k)
    assert_adam_weights(G, state["paramsG"], 1e-4)
    assert_adam_weights(D, state["paramsD"], 1e-4)


# ----------------------------------------------------- vocoder_hifigan


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """vocoder_hifigan.yaml at the shipped widths over a synthetic corpus
    (one crop of VOC_FRAMES frames a step); (config, port G, port D)."""
    root = tmp_path_factory.mktemp("hifigan")
    chip_smoke.write_vocoder_corpus(root / "in", n=2, frames=40)
    cfg, jcfg = _files(VOC_FILE)
    assert cfg == jcfg
    cfg = chip_smoke.vocoder_train_config(
        root / "in", root / "exp", "vocoder/vocoder_hifigan.yaml",
        data={"crop_frames": VOC_FRAMES}, batch_size=1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        G = vocoder_trainer.build_generator(cfg)
        D = instantiate(cfg.model.discriminator)
    return cfg, G, D


def test_vocoder_hifigan_is_built_from_its_file(voc):
    cfg, G, D = voc
    assert type(G).__name__ == "HiFiGANGenerator"
    assert type(D).__name__ == "HiFiGANMultiScaleMultiPeriodDiscriminator"
    assert cfg.model.generator.channels == 512
    assert list(cfg.model.generator.upsample_scales) == [5, 4, 4, 3]
    jG = jax_instantiate(cfg.model.generator)
    c = np.zeros((1, 4, cfg.model.generator.aux_channels), np.float32)
    tree = jax.eval_shape(lambda: jG.init(jax.random.PRNGKey(0), c))
    got = jax.tree_util.tree_leaves_with_path(torch_to_flax(G)["params"])
    want = jax.tree_util.tree_leaves_with_path(tree["params"])
    assert [(p, np.shape(a)) for p, a in got] == [
        (p, a.shape) for p, a in want]


def test_vocoder_hifigan_generator_matches_jax(voc):
    cfg, G, _ = voc
    jG = jax_instantiate(cfg.model.generator)
    c = np.random.default_rng(5).standard_normal(
        (1, 6, cfg.model.generator.aux_channels)).astype(np.float32)
    ref = np.asarray(jG.apply(torch_to_flax(G), jnp.asarray(c)))
    with torch.no_grad():
        got = G(torch.from_numpy(c)).numpy()
    assert got.shape == ref.shape and got.shape[1] == 6 * 240
    peak = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GEN_RTOL * peak)


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel() for _, a in
                           jax.tree_util.tree_leaves_with_path(tree)])


def port_moment(module, optimizer):
    """Adam's first moment of ``module``'s weights after one step,
    (1 - b1) times the clipped gradient, as a flat float64 vector in flax
    path order."""
    twin = copy.deepcopy(module).double()
    with torch.no_grad():
        for t, p in zip(twin.parameters(), module.parameters()):
            t.copy_(optimizer.state[p]["exp_avg"])
    return _flat(torch_to_flax(twin)["params"])


def jax_moment(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return _flat(adam[0].mu)


def jax_step_f64(cfg, G64, D64, batch):
    """JAX's step in float64 (x64, which holds in the calling thread
    only) from the float64 modules' weights on ``batch``: (its metrics,
    [G's, D's] Adam first moments)."""
    with jax.enable_x64(True):
        jstep, state = jax_vocoder_step(cfg, G64, D64)
        state, ref = jstep(state, {k: v.astype(np.float64)
                                   for k, v in batch.items()})
        return ({k: float(v) for k, v in ref.items()},
                [jax_moment(state[f"opt{net}_state"]) for net in "GD"])


def test_vocoder_hifigan_gan_step_matches_jax(voc):
    """One step from the same weights and crop, judged as
    ``chip_smoke.hold_gan_step`` judges the card.  The port's float64
    step is JAX's float64 step (every metric and Adam first moment within
    F64_RTOL), so the port computes JAX's function; then each float32
    metric lies within ``tests/test_torch_vocoder_train.py``'s tolerance
    of JAX's, and each network's gradient (Adam's first moment after the
    step) within VOCODER_TRAIN_GRAD_RTOL of JAX's in L2 over its norm;
    or, failing that, the port's float32 run is no farther from the
    float64 step than HEADROOM times JAX's.  (At the shipped widths one
    Adam step moves 1.2% of the weights by noise-level gradients' signs,
    so the weights themselves are no judge.)  JAX's two steps run on
    threads beside the port's."""
    cfg, G, D = voc
    b = {k: v.numpy() for k, v in chip_smoke.vocoder_batches(
        cfg, 1, "cpu")[0].items()}
    with ThreadPoolExecutor(2) as pool:
        jax64 = pool.submit(jax_step_f64, cfg, copy.deepcopy(G).double(),
                            copy.deepcopy(D).double(), b)
        jstep, state = jax_vocoder_step(cfg, G, D)
        jax32 = pool.submit(jstep, state, b)
        G64, D64 = copy.deepcopy(G).double(), copy.deepcopy(D).double()
        step64 = vocoder_trainer.gan_step(cfg, G64, D64, "cpu")
        f64 = {k: float(v) for k, v in step64(
            {k: torch.from_numpy(v).double() for k, v in b.items()}).items()}
        f64_moments = [port_moment(m, o) for m, o in zip(
            (G64, D64), step64.optimizers)]
        del G64, D64, step64
        step = vocoder_trainer.gan_step(cfg, G, D, "cpu")
        got = {k: float(v) for k, v in step(
            {k: torch.from_numpy(v) for k, v in b.items()}).items()}
        state, ref = jax32.result()
        j64, j64_moments = jax64.result()
    assert sorted(f64) == sorted(j64)
    for k in j64:
        assert abs(f64[k] - j64[k]) <= F64_RTOL * max(abs(j64[k]), 1e-12), (
            k, f64[k], j64[k])
    for net, mine, theirs in zip("GD", f64_moments, j64_moments):
        assert (np.linalg.norm(mine - theirs)
                <= F64_RTOL * np.linalg.norm(theirs)), net
    ref = {k: float(v) for k, v in ref.items()}
    assert sorted(got) == sorted(ref) == sorted(f64)
    for k in ref:
        tol = GRADNORM_RTOL if k == "GradNorm_G" else VOC_METRIC_RTOL
        rel = abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-7)
        assert rel < tol or abs(got[k] - f64[k]) <= HEADROOM * abs(
            ref[k] - f64[k]), (k, got[k], ref[k], f64[k])
    for i, net in enumerate(("G", "D")):
        mine = port_moment((G, D)[i], step.optimizers[i])
        theirs = jax_moment(state[f"opt{net}_state"])
        oracle = f64_moments[i]
        rel = np.linalg.norm(mine - theirs) / np.linalg.norm(theirs)
        assert rel < chip_smoke.VOCODER_TRAIN_GRAD_RTOL or (
            np.linalg.norm(mine - oracle)
            <= HEADROOM * np.linalg.norm(theirs - oracle)), (net, rel)
