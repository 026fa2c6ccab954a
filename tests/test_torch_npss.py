"""The port's multitrack NPSS cascade (``models/acoustic/npss.py``) against
the JAX package's on the CPU: the recipe's diffusion ensemble voice
(``chip_smoke.diffusion_acoustic_config``: the shipped
``multitrack_acoustic_npss_diff_mgcbap.yaml`` at tiny widths, its two
``GaussianDiffusion`` chains 4 steps long) with random weights, the
port's torch initial ones carried to flax by ``torch_to_flax``.

``inference_main`` and ``inference`` over mixed lengths with the JAX
chains' noise replayed (``tests/test_torch_diffusion.jax_chains``), at
1e-4; the training forward, teacher-forced, with JAX's diffusion t and
noise replayed, with and without ``output_subtrack`` and as the V2
variant; the weights both ways from a JAX initialisation.  The AR lf0
decoder's inference-time prenet dropout cannot reproduce jax.random's
bits, so these tests set ``prenet_dropout = 0``, as
tests/test_torch_svs.py does.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.models import diffsinger as jdiff
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.models import diffsinger
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_diffusion import jax_chains, randn
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ATOL = 1e-4
B, T = 3, 40
SPKS = ([0, 1, 2], [1, 2, 0])
PKG = "ensemble_svs_with_interactions_tpu.models.acoustic"


def net_config(subtrack=False, v2=False, k_step=4):
    net = chip_smoke.diffusion_acoustic_config(
        tiny=True, subtrack=subtrack, k_step=k_step)["netG"]
    net["lf0_model"]["prenet_dropout"] = 0.0
    if v2:
        net["_target_"] = (
            f"{PKG}.V2MultiTrackNPSSMDNMultistreamParametricModel")
    return net


def twins(cfg, seed=0):
    torch.manual_seed(seed)
    module = instantiate(cfg).eval()
    return module, jax_instantiate(cfg), torch_to_flax(module)


def inputs(seed=0):
    """Main and sub features (B, T, 86) over mixed lengths, their
    speakers and lengths: host arrays and torch tensors."""
    xm = np.abs(randn(B, T, 86, seed=seed)) * 0.3
    xs = np.abs(randn(B, T, 86, seed=seed + 1)) * 0.3
    lengths = np.asarray([T, T - 7, T - 16])
    for i, n in enumerate(lengths):
        xm[i, n:] = xs[i, n:] = 0
    spks = tuple(np.asarray(s, np.int32) for s in SPKS)
    jax_args = (jnp.asarray(xm), jnp.asarray(xs),
                tuple(jnp.asarray(s) for s in spks), jnp.asarray(lengths))
    port_args = (torch.from_numpy(xm), torch.from_numpy(xs),
                 tuple(torch.from_numpy(s).long() for s in spks),
                 torch.from_numpy(lengths))
    return jax_args, port_args, lengths


def valid(lengths):
    return np.arange(T)[None, :] < lengths[:, None]


@pytest.fixture(scope="module")
def model():
    return twins(net_config())


@pytest.mark.parametrize("method", ["inference_main", "inference"])
def test_inference_matches_jax(model, method):
    """[mgc | lf0 | vuv | bap] of the main tracks: the AR lf0 model, both
    chains (mgc sampled before bap) and the vuv model conditioned on (x,
    mgc, lf0); ``inference`` returns the output twice, as JAX does."""
    module, jmod, v = model
    jax_args, port_args, lengths = inputs()
    with jax_chains() as draws:
        ref = jmod.apply(v, *jax_args, method=method,
                         rngs={"diffusion": jax.random.PRNGKey(5),
                               "prenet": jax.random.PRNGKey(6)})
        ref = jax.tree_util.tree_map(np.asarray, ref)
    assert [d["x_T"].shape for d in draws] == [(B, T, 60), (B, T, 5)]
    with diffsinger.chain_noise(draws):
        got = getattr(module, method)(*port_args)
    if method == "inference":
        assert isinstance(got, tuple) and len(got) == 2
        assert got[0] is got[1]
        np.testing.assert_array_equal(ref[0], ref[1])
        got, ref = got[0], ref[0]
    assert got.shape == ref.shape == (B, T, 67)
    m = valid(lengths)
    assert np.abs(ref[m]).max() > 0.5
    np.testing.assert_allclose(got.numpy()[m], ref[m], atol=ATOL)


def test_inference_main_draws_from_its_chain_generator(model):
    """Without a replay block the chains draw from ``chain_generator``:
    seeded alike, the same output; seeded otherwise, another mgc and bap
    but the same lf0."""
    module = model[0]
    _, port_args, _ = inputs()
    outs = [module.inference_main(*port_args, chain_generator=torch
                                  .Generator().manual_seed(s))
            for s in (1, 1, 2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0][..., :60], outs[2][..., :60])
    torch.testing.assert_close(outs[0][..., 60], outs[2][..., 60], rtol=0,
                               atol=0)


def _jax_train(jmod, v, jax_args, ys, train):
    """The JAX training forward and its diffusion draws as ``chain_noise``
    training entries: t captured at each denoiser call (mgc, then bap),
    the noise from the (noise, x_recon) each stream returns."""
    ts = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jdiff.DiffNet):
            ts.append(np.asarray(args[1]))
        return next_fun(*args, **kwargs)

    xm, xs, spks, lengths = jax_args
    with fnn.intercept_methods(interceptor):
        out = jmod.apply(v, xm, xs, spks, lengths,
                         tuple(jnp.asarray(y) for y in ys), train=train,
                         rngs={"diffusion": jax.random.PRNGKey(8),
                               "dropout": jax.random.PRNGKey(9),
                               "prenet": jax.random.PRNGKey(10)},
                         mutable=["batch_stats"] if train else False)
    out = out[0] if train else out
    out = jax.tree_util.tree_map(
        lambda a: None if a is None else np.asarray(a), out,
        is_leaf=lambda a: a is None)
    (mgc, _, _, bap), _ = out[0]
    entries = [{"t": t, "noise": s[0]} for t, s in zip(ts, (mgc, bap))]
    return out, entries


def _flat(tree):
    return jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: a, tree, is_leaf=lambda a: a is None),
        is_leaf=lambda a: a is None)


@pytest.mark.parametrize("subtrack,v2,train,output_subtrack", [
    (False, False, False, None), (False, False, False, False),
    (True, False, False, None), (True, True, False, None),
    (True, False, True, None)],
    ids=["shipped", "output_subtrack_false", "subtrack", "v2",
         "subtrack_train"])
def test_training_forward_matches_jax(subtrack, v2, train, output_subtrack):
    """Teacher-forced: the main track's (mgc as (noise, x_recon), lf0,
    vuv, bap as (noise, x_recon)) and lf0 residual, and with
    ``output_subtrack`` (the default, which the shipped config keeps and
    its ``_subtrack`` twin sets) the sub track's (y_mgc, lf0, y_vuv,
    y_bap) and residual; without it (None, None).  In training (vuv
    dropout off: its masks cannot match) the batch norms use the batch's
    statistics."""
    cfg = net_config(subtrack=subtrack, v2=v2)
    if output_subtrack is not None:
        cfg["output_subtrack"] = output_subtrack
    if train:
        cfg["vuv_model"]["dropout"] = 0.0
    module, jmod, v = twins(cfg, seed=1)
    assert module.output_subtrack == jmod.output_subtrack == (
        output_subtrack is not False)
    jax_args, port_args, lengths = inputs(seed=3)
    ys = (randn(B, T, 67, seed=4), randn(B, T, 67, seed=5))
    ref, entries = _jax_train(jmod, v, jax_args, ys, train)
    with diffsinger.chain_noise(entries):
        got = module(*port_args, ys=tuple(torch.from_numpy(y) for y in ys),
                     train=train, generator=torch.Generator().manual_seed(0))
    if not jmod.output_subtrack:
        assert got[1] == (None, None) and ref[1] == (None, None)
    ref_leaves, got_leaves = _flat(ref), _flat(got)
    assert len(got_leaves) == len(ref_leaves) >= 7
    for r, g in zip(ref_leaves, got_leaves):
        assert (r is None) == (g is None)
        if r is not None:
            np.testing.assert_allclose(g.detach().numpy(), r, atol=ATOL)


def test_weights_round_trip():
    """The cascade's flax variables (lf0_model, mgc_model and bap_model
    with their encoders and denoisers, vuv_model, speaker_embedding,
    batch statistics: the tree of flax's ``init``, traced by
    ``jax.eval_shape``, every leaf a seeded normal draw) load into the
    port and come back bitwise."""
    cfg = net_config()
    jmod = jax_instantiate(cfg)
    z = jnp.zeros((1, 8, 86))
    spks = (jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.int32))
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2), "prenet": jax.random.PRNGKey(3)},
        z, z, spks, jnp.asarray([8]),
        (jnp.zeros((1, 8, 67)), jnp.zeros((1, 8, 67)))))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    assert set(v["params"]) == {"lf0_model", "mgc_model", "bap_model",
                                "vuv_model", "speaker_embedding"}
    back = torch_to_flax(flax_to_torch(instantiate(cfg), v))
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(v)]
    for (p, a), (_, b) in zip(flat(back), flat(v)):
        np.testing.assert_array_equal(a, b, str(p))


def test_jax_multitrack_step_cannot_train_the_diffusion_voice():
    """A finding the port does not copy: the JAX multitrack acoustic step
    passes ``{"dropout", "prenet", "zoneout"}`` keys in training and
    ``{"prenet"}`` in evaluation (``train/multitrack.py:198-202``), while
    ``GaussianDiffusion`` draws t and its noise from ``"diffusion"``
    (``models/diffsinger.py:195``), so its train and eval steps raise
    ``InvalidRngError`` on the diffusion voice.  The port's step, whose
    forward takes a generator, computes what the JAX pieces give: the
    JAX forward with a ``"diffusion"`` key, its t and noise replayed, then
    JAX's ``multitrack_acoustic_loss`` and pitch regularization, each
    metric at ATOL; and it takes a finite training step."""
    import flax.errors
    import optax

    from ensemble_svs_with_interactions_tpu.train import losses as jax_losses
    from ensemble_svs_with_interactions_tpu.train import (
        multitrack as jax_mt,
    )
    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack as port_mt,
    )

    cfg = net_config()
    module, jmod, v = twins(cfg, seed=1)
    jax_args, _, lengths = inputs(seed=3)
    ys = (randn(B, T, 67, seed=4), randn(B, T, 67, seed=5))
    batch = {"in_feats0": np.array(jax_args[0]),
             "in_feats1": np.array(jax_args[1]),
             "out_feats0": ys[0], "out_feats1": ys[1],
             "spks0": np.asarray(SPKS[0], np.int32),
             "spks1": np.asarray(SPKS[1], np.int32), "lengths": lengths}
    weights = {"logf0_diff": 0.5, "mgc_diff": 0.25}
    model_config = {"stream_sizes": [60, 1, 1, 5]}

    opt = optax.sgd(1e-3)
    train_step, eval_step = jax_mt.create_multitrack_acoustic_train_step(
        jmod, opt, model_config, donate=False)
    state = {"params": v["params"], "batch_stats": v.get("batch_stats", {}),
             "opt_state": opt.init(v["params"]), "step": 0}
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jweights = {k: jnp.asarray(w) for k, w in weights.items()}
    with pytest.raises(flax.errors.InvalidRngError, match="diffusion"):
        train_step(state, jbatch, jweights, jax.random.PRNGKey(0))
    with pytest.raises(flax.errors.InvalidRngError, match="diffusion"):
        eval_step(state, jbatch, jweights)

    (main, sub), entries = _jax_train(jmod, v, jax_args, ys, train=False)
    mask = jnp.asarray(valid(lengths), jnp.float32)[:, :, None]
    feats, lf0_inter, mgc0_inter = jax_mt.multitrack_acoustic_loss(
        main[0], sub[0], jnp.asarray(ys[0]), jnp.asarray(ys[1]), mask,
        model_config["stream_sizes"], prediction_type=jmod.prediction_type())
    pitch = jax_losses.pitch_regularization_loss(main[1], mask, 1.0)
    ref = {"Loss_Feats": feats, "Loss_Pitch": pitch,
           "Loss_LogF0_Interaction": lf0_inter,
           "Loss_MGC-0th_Interaction": mgc0_inter,
           "Loss": feats + pitch + weights["logf0_diff"] * lf0_inter
           + weights["mgc_diff"] * mgc0_inter}
    port_train, port_eval = port_mt.create_multitrack_acoustic_train_step(
        module, torch.optim.SGD(module.parameters(), lr=1e-3), model_config,
        device="cpu")
    with diffsinger.chain_noise(entries):
        got, _ = port_eval(batch, weights)
    assert ref["Loss"] > 1.0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], float(r), atol=ATOL, err_msg=k)
    metrics = port_train(batch, weights, torch.Generator().manual_seed(0))
    assert all(np.isfinite(m) for m in metrics.values()), metrics
