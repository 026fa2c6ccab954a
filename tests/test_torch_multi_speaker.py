"""The multi-speaker models on the port against the JAX package, on the
CPU, at tiny widths: ``MultiSpeakerFFConvLSTM`` (``models/generic.py``),
``MultiSpeakerMultistreamSeparateF0ParametricModel``
(``models/acoustic/multistream.py``, the shipped
``multi_speaker_acoustic_multistream_ar_f0.yaml`` narrowed),
``MultiSpeakerNPSSMDNMultistreamParametricModel``
(``models/acoustic/npss.py``), the FFT encoder's speaker input
(``spk_fc``), ``MultiSpeakerGaussianDiffusion`` and
``MultiSpeakerFlowMatching``; one train step, and ``train_model`` of the
narrowed shipped config against JAX's on a three-speaker corpus.

Weights are the port's, drawn by ``utils/flax_init`` and carried to JAX
with ``torch_to_flax``; outputs at ATOL 1e-5 in evaluation and in a
training forward (dropout and prenet dropout 0: masks cannot match
across frameworks); the diffusion and flow-matching draws are replayed
from JAX's (``tests/test_torch_mel_models.same_draws``).  The step is
judged by ``tests/test_torch_trainer.assert_step_matches_jax``, the
trainers as ``tests/test_torch_trainer.py`` judges them (2 epochs, SGD,
one start checkpoint).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.models import (
    generic as jax_generic,
)
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.models import (
    MultiSpeakerFFConvLSTM,
    diffsinger,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    merge,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
    init_variables,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_mel_models import (  # noqa: F401  (same_draws)
    diffnet,
    draw_normal,
    fft,
    same_draws,
    training_draws,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_torch_trainer import assert_step_matches_jax, run
from tests.test_torch_trainer_multitrack import (
    ACOUSTIC_DATA,
    NEPOCHS,
    SGD,
    assert_trainers_agree,
)

ATOL = 1e-5
B, T = 3, 24
LENGTHS = np.array([T, T - 5, T - 11])
SPKS = np.array([2, 0, 1])
PKG = "ensemble_svs_with_interactions_tpu.models"
IN, E = 12, 6


def spk_table(n=3, dim=E):
    return {"_target_": f"{PKG}.SpeakerEmbedding", "num_embeddings": n,
            "embedding_dim": dim, "std": 0.5}


def inputs(in_dim=IN, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, T, in_dim)).astype(np.float32)
    return x * (np.arange(T)[None, :, None] < LENGTHS[:, None, None])


def close(got, want, atol=ATOL):
    if want is None:
        assert got is None
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, atol)
        return
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def twins(net, seed=0):
    """(port module, JAX module, JAX variables): the port's flax-scheme
    weights (running statistics perturbed) carried to JAX."""
    module = init_module(instantiate(net), seed=seed)
    rng = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=rng) * 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=rng) + 0.5)
    return module.eval(), jax_instantiate(net), torch_to_flax(module)


def assert_stats_match(module, updates):
    """The port's running statistics after a training forward against
    JAX's ``batch_stats`` update."""
    stats = torch_to_flax(module)["batch_stats"]
    for path, value in jax.tree_util.tree_leaves_with_path(updates):
        node = stats
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(value), rtol=0,
                                   atol=ATOL, err_msg=str(path))


# ------------------------------------------------------- the configs
def ffconvlstm(in_dim=IN, out_dim=4, **kw):
    return {"_target_": f"{PKG}.MultiSpeakerFFConvLSTM", "in_dim": in_dim,
            "speaker_embedding": spk_table(dim=kw.pop("spk_dim", in_dim)),
            "ff_hidden_dim": 8, "conv_hidden_dim": 6, "lstm_hidden_dim": 4,
            "out_dim": out_dim, "num_lstm_layers": 2, "dropout": 0.0, **kw}


def multistream(**kw):
    """The shipped multi-speaker voice narrowed (``chip_smoke``'s TINY),
    prenet dropout and dropout 0."""
    cfg = chip_smoke.multi_speaker_acoustic_config(tiny=True)
    net = cfg["netG"]
    net["lf0_model"]["prenet_dropout"] = 0.0
    for k in ("mgc_model", "vuv_model"):
        net[k]["dropout"] = 0.0
    net.update(kw)
    return cfg


def _stream(out_dim, in_dim, mdn=True):
    return {"_target_": f"{PKG}.FFConvLSTM", "in_dim": in_dim,
            "out_dim": out_dim, "ff_hidden_dim": 8, "conv_hidden_dim": 6,
            "lstm_hidden_dim": 4, "num_lstm_layers": 1, "use_mdn": mdn,
            "num_gaussians": 2, "dim_wise": True, "embed_dim": E,
            "in_ph_start_idx": 2, "in_ph_end_idx": 7}


def npss_mdn():
    """The multi-speaker MDN cascade: FFConvLSTM stream models (MDN heads
    but V/UV's), each with a phoneme embedding of the speaker table's
    width, so the speaker embeddings add to every one."""
    ss = [4, 1, 1, 2]
    return {"_target_":
            f"{PKG}.acoustic.MultiSpeakerNPSSMDNMultistreamParametricModel",
            "in_dim": IN, "out_dim": sum(ss), "stream_sizes": ss,
            "lf0_model": _stream(1, IN), "mgc_model": _stream(4, IN + 1),
            "bap_model": _stream(2, IN + 1),
            "vuv_model": _stream(1, IN + 1 + 2, mdn=False),
            "speaker_embedding": spk_table()}


def diffusion(cls="diffsinger.MultiSpeakerGaussianDiffusion",
              encoder=True):
    net = {"_target_": f"{PKG}.{cls}", "in_dim": IN, "out_dim": 5,
           "denoise_fn": diffnet(5, 8 if encoder else IN),
           "speaker_embedding": spk_table()}
    if encoder:
        net["encoder"] = fft()
    if "Gaussian" in cls:
        net["K_step"] = 4
    else:
        net["sampling_steps"] = 2
    return net


# -------------------------------------------------------------- modules
@pytest.mark.parametrize("kw,spk_shape", [
    ({}, (B,)),
    ({"use_mdn": True, "num_gaussians": 2, "embed_dim": E, "spk_dim": E,
      "in_ph_start_idx": 2, "in_ph_end_idx": 7}, (B, 1)),
], ids=["linear", "mdn_embed"])
def test_multi_speaker_ffconvlstm_matches_jax(kw, spk_shape):
    """Evaluation, ``inference`` and a training forward (its running
    statistics too), with speaker ids of shape (B,) or (B, 1)."""
    module, jm, v = twins(ffconvlstm(**kw))
    x, spks = inputs(), SPKS.reshape(spk_shape)
    args = (torch.from_numpy(x), torch.from_numpy(spks),
            torch.from_numpy(LENGTHS))
    with torch.no_grad():
        close(module(*args), jm.apply(v, x, spks, LENGTHS))
        close(module.inference(*args),
              jm.apply(v, x, spks, LENGTHS, method=jm.inference))
        got = module(*args, train=True, generator=torch.Generator())
    want, updates = jm.apply(v, x, spks, LENGTHS, train=True,
                             mutable=["batch_stats"])
    close(got, want)
    assert_stats_match(module, updates["batch_stats"])


def test_jax_multi_speaker_ffconvlstm_refuses_a_config_node():
    """JAX's ``MultiSpeakerFFConvLSTM`` takes its speaker table as a module
    only: flax freezes a config node into a ``FrozenDict``, which
    ``_as_module`` (``generic.py:504``) refuses.  The port builds the
    table from the node, as ``_as_module`` means to (not copied: ROADMAP
    Queue 3)."""
    node = {"num_embeddings": 3, "embedding_dim": IN}
    kw = {k: v for k, v in ffconvlstm().items()
          if k not in ("_target_", "speaker_embedding")}
    jm = jax_generic.MultiSpeakerFFConvLSTM(speaker_embedding=node, **kw)
    with pytest.raises(TypeError, match="FrozenDict"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), inputs(),
                                       SPKS, LENGTHS))
    module = MultiSpeakerFFConvLSTM(speaker_embedding=node, **kw)
    assert tuple(module.speaker_embedding.Embed_0.weight.shape) == (3, IN)
    built = MultiSpeakerFFConvLSTM(speaker_embedding=instantiate(
        spk_table(dim=IN)), **kw)
    assert sorted(torch_to_flax(module)["params"]) == \
        sorted(torch_to_flax(built)["params"]) == ["backbone",
                                                   "speaker_embedding"]


@pytest.mark.parametrize("forcing", [True, False])
def test_multi_speaker_multistream_matches_jax(forcing):
    """The narrowed shipped voice: teacher-forced training forward (its
    running statistics too), then free-running and ``inference``; the
    speakers change the output."""
    cfg = multistream(lf0_teacher_forcing=forcing)
    module, jm, v = twins(cfg["netG"])
    x = inputs(86, seed=1)
    x[..., 51] = np.repeat(np.random.default_rng(2).uniform(
        0.3, 0.7, (B, T // 4)), 4, axis=1)
    y = np.random.default_rng(3).normal(size=(B, T, 67)).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(SPKS),
            torch.from_numpy(LENGTHS))
    rngs = {"prenet": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    want, updates = jm.apply(v, x, SPKS, LENGTHS, y, train=True, rngs=rngs,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = module(*args, torch.from_numpy(y), train=True,
                     generator=torch.Generator())
    close(got, want)
    assert_stats_match(module, updates["batch_stats"])
    module.eval()
    flax_to_torch(module, v)
    with torch.no_grad():
        close(module(*args, generator=torch.Generator()),
              jm.apply(v, x, SPKS, LENGTHS, rngs=rngs))
        got = module.inference(*args, generator=torch.Generator())
        close(got, jm.apply(v, x, SPKS, LENGTHS, rngs=rngs,
                            method=jm.inference))
        other = module.inference(args[0], torch.from_numpy(SPKS[::-1].copy()),
                                 args[2], generator=torch.Generator())
    assert got.shape == (B, T, 67)
    assert (got[0] - other[0]).abs().max() > 1e-4


def test_multi_speaker_npss_mdn_matches_jax():
    """Teacher-forced (the MDN stream tuples) and free-running (the point
    estimates [mgc | lf0 | vuv | bap]) with every stream model
    speaker-conditioned."""
    module, jm, v = twins(npss_mdn())
    x = inputs(seed=4)
    y = np.random.default_rng(5).normal(size=(B, T, 8)).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(SPKS),
            torch.from_numpy(LENGTHS))
    with torch.no_grad():
        close(module(*args, torch.from_numpy(y)),
              jm.apply(v, x, SPKS, LENGTHS, y))
        got = module.inference(*args)
        close(got, jm.apply(v, x, SPKS, LENGTHS, method=jm.inference))
    assert got.shape == (B, T, 8)


@pytest.mark.parametrize("kw", [
    {"reduction_factor": 2, "out_dim": 3},
    {"reduction_factor": 3, "downsample_by_conv": False, "out_dim": 3},
], ids=["r2_conv", "r3_skip"])
def test_fft_encoder_speaker_input_matches_jax(kw):
    """Speaker embeddings through ``spk_fc``, every r-th frame of them
    under a reduction factor (by a strided conv or by skipping), at T not
    a multiple of r (r = 1 is held by the diffusion decoders' tests)."""
    net = fft(**kw)
    module = instantiate(net)
    with pytest.raises(ValueError, match="spk_fc"):
        module(torch.zeros(1, 4, IN), spk_embs=torch.zeros(1, 4, E))
    module.add_speaker_input(E)
    init_module(module, seed=1).eval()
    v = torch_to_flax(module)
    x = inputs(seed=6)[:, :T - 1]
    e = np.random.default_rng(7).normal(size=(B, T - 1, E)).astype(
        np.float32)
    lengths = np.minimum(LENGTHS, T - 1)
    got = module(torch.from_numpy(x), torch.from_numpy(lengths),
                 spk_embs=torch.from_numpy(e))
    close(got, jax_instantiate(net).apply(v, x, lengths, None, e))


def sample(module, cond, spks, lengths):
    """``module.inference`` on JAX's draws (``same_draws``): the DDPM's
    x_T and ancestral steps through the patched ``diffsinger._normal``,
    the flow's x_T through ``chain_noise``."""
    if isinstance(module, diffsinger.GaussianDiffusion):
        return module.inference(cond, spks, lengths)
    shape = (cond.shape[0], cond.shape[1], module.out_dim)
    with diffsinger.chain_noise([{"x_T": draw_normal(shape),
                                  "steps": None}]):
        return module.inference(cond, spks, lengths)


@pytest.mark.parametrize("cls", ["diffsinger.MultiSpeakerGaussianDiffusion",
                                 "flow_matching.MultiSpeakerFlowMatching"])
def test_multi_speaker_generative_decoders_match_jax(same_draws, cls):
    """Training ((drawn target, prediction) with JAX's draws) and sampling
    (from JAX's x_T, the ancestral steps' draws too), the speakers
    reaching the net through the FFT encoder's ``spk_fc``."""
    module, jm, v = twins(diffusion(cls))
    assert "spk_fc" in v["params"]["encoder"]
    x = inputs(seed=8)
    y = np.random.default_rng(9).normal(size=(B, T, 5)).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(SPKS),
            torch.from_numpy(LENGTHS))
    rngs = {"diffusion": jax.random.PRNGKey(0)}
    K = 4 if "Gaussian" in cls else None
    with diffsinger.chain_noise([training_draws((B, T, 5), K)]):
        got = module(*args, torch.from_numpy(y))
    close(got, jm.apply(v, x, SPKS, LENGTHS, y, rngs=rngs))
    got = sample(module, *args)
    close(got, jm.apply(v, x, SPKS, LENGTHS, rngs=rngs,
                        method=jm.inference), atol=1e-4)
    other = sample(module, args[0], torch.from_numpy(SPKS[::-1].copy()),
                   args[2])
    assert (got[0] - other[0]).abs().max() > 1e-4


@pytest.mark.parametrize("cls", ["diffsinger.MultiSpeakerGaussianDiffusion",
                                 "flow_matching.MultiSpeakerFlowMatching"])
def test_encoderless_decoders_ignore_the_speakers_as_jax(same_draws, cls):
    """Without a condition encoder the speaker embeddings reach nothing
    (JAX's ``tests/test_flow_matching.py:184-186``; copied): the samples
    and the training pair are the same for every speaker, in both
    packages, and equal each other."""
    module, jm, v = twins(diffusion(cls, encoder=False))
    x = inputs(seed=10)
    y = np.random.default_rng(11).normal(size=(B, T, 5)).astype(np.float32)
    rngs = {"diffusion": jax.random.PRNGKey(0)}
    outs = []
    for spks in (SPKS, SPKS[::-1].copy()):
        args = (torch.from_numpy(x), torch.from_numpy(spks),
                torch.from_numpy(LENGTHS))
        got = sample(module, *args)
        close(got, jm.apply(v, x, spks, LENGTHS, rngs=rngs,
                            method=jm.inference), atol=1e-4)
        K = 4 if "Gaussian" in cls else None
        with diffsinger.chain_noise([training_draws((B, T, 5), K)]):
            pair = module(*args, torch.from_numpy(y))
        close(pair, jm.apply(v, x, spks, LENGTHS, y, rngs=rngs))
        outs.append((got, pair[1]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_unported_holds_only_vibrato():
    """Every multi-speaker model builds; ``gen.UNPORTED`` named only the
    vibrato streams, and names nothing since they were ported
    (tests/test_torch_streaming.py)."""
    assert set(gen.UNPORTED) == set()
    for net in (diffusion(), diffusion("flow_matching.MultiSpeakerFlowMatching"),
                npss_mdn(), ffconvlstm(), multistream()["netG"]):
        assert instantiate(net).speaker_embedding is not None


def test_shipped_config_builds_at_its_widths():
    """``configs/acoustic/multi_speaker_acoustic_multistream_ar_f0.yaml``
    read as a file builds the port's voice at its widths: the 17 x 256
    speaker table, the 512 x 3 encoder, the decoders' LSTMs of 256 / 64 /
    64 units."""
    from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
        MultiSpeakerMultistreamSeparateF0ParametricModel as Model,
    )

    module = instantiate(chip_smoke.multi_speaker_acoustic_config()["netG"])
    assert type(module) is Model
    assert tuple(module.speaker_embedding.Embed_0.weight.shape) == (17, 256)
    assert tuple(module.encoder.LSTM_0.l2_bwd.w_h.shape) == (512, 2048)
    for name, H in (("mgc", 256), ("vuv", 64), ("bap", 64)):
        lstm = getattr(module, f"{name}_model").LSTM_0
        assert tuple(lstm.l1_fwd.w_h.shape) == (H, 4 * H), name
    assert module.lf0_model.reduction_factor == 4


# -------------------------------------------------------------- weights
TEMPLATES = {
    "ffconvlstm": (ffconvlstm(use_mdn=True), IN, None),
    "multistream": (multistream()["netG"], 86, 67),
    "npss_mdn": (npss_mdn(), IN, 8),
    "diffusion": (diffusion(), IN, 5),
    "flow_matching": (diffusion("flow_matching.MultiSpeakerFlowMatching"),
                      IN, 5),
}


@pytest.mark.parametrize("case", sorted(TEMPLATES))
def test_weights_round_trip_in_jax_s_layout(case):
    """``init_variables`` gives the JAX ``init``'s tree (every path and
    shape, traced), and ``flax_to_torch`` of ``torch_to_flax`` reproduces
    every tensor bitwise."""
    net, in_dim, out_dim = TEMPLATES[case]
    module = init_module(instantiate(net), seed=3)
    tree = torch_to_flax(module)
    twin = flax_to_torch(instantiate(net), tree)
    for (k, a), (_, b) in zip(module.state_dict().items(),
                              twin.state_dict().items()):
        assert torch.equal(a, b), k
    jm = jax_instantiate(net)
    args = [jnp.zeros((1, 8, in_dim)), jnp.zeros((1,), jnp.int32),
            jnp.array([8])]
    if out_dim is not None:
        args.append(jnp.zeros((1, 8, out_dim)))
    want = jax.eval_shape(lambda: jm.init(
        {k: jax.random.PRNGKey(i) for i, k in enumerate(
            ("params", "dropout", "prenet", "diffusion"))}, *args,
        train=True))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(want))
    got = init_variables(instantiate(net), seed=0)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == shapes


# ------------------------------------------------------------- training
def test_multi_speaker_step_matches_jax():
    """One single-track train step of ``MultiSpeakerFFConvLSTM`` with the
    batch's speaker ids (the trainer's ``spks``)."""
    net = ffconvlstm(in_dim=IN, out_dim=4)
    net["num_lstm_layers"] = 1
    cfg = {"netG": net, "stream_sizes": [4], "has_dynamic_features":
           [False], "num_windows": 1}
    rng = np.random.default_rng(12)
    batch = {"in_feats": inputs(seed=12),
             "out_feats": rng.normal(size=(B, T, 4)).astype(np.float32),
             "lengths": LENGTHS.astype(np.int32),
             "spks": SPKS.astype(np.int32)}
    variables = torch_to_flax(init_module(instantiate(net), seed=4))
    assert_step_matches_jax(cfg, {"pitch_reg_weight": 0.0}, batch, variables)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three singers' acoustic dumps, ``{Vo1,S1,ritsu}_seg*-feats.npy``."""
    return chip_smoke.write_corpus(tmp_path_factory.mktemp("corpus"), 2, 1,
                                   (40, 64), seed=7, timing_dim=4)


def tiny_trainer_model():
    """The narrowed shipped voice with one-layer LSTMs and the decoders'
    feed-forward layers 32 wide (so no frame's ReLUs all die), as
    ``tests/test_torch_trainer.single_acoustic_model``."""
    cfg = multistream()
    net = cfg["netG"]
    for k in ("mgc_model", "vuv_model", "bap_model"):
        net[k].update(num_lstm_layers=1, ff_hidden_dim=32, dropout=0.0)
    net["encoder"]["num_layers"] = 1
    net["lf0_model"]["num_lstm_layers"] = 1
    return cfg


def test_train_model_matches_jax(corpus, tmp_path):
    """``train_model(is_acoustic=True)`` with ``data.spk_names`` (as
    ``bin/train_acoustic_multi.py`` runs it) against JAX's, from one start
    checkpoint: the speaker ids from the file names, random crops, l1, the
    pitch regularization, a dev pass with distortions."""
    cfg = chip_smoke.multi_speaker_trainer_config(
        corpus, tmp_path, tiny_trainer_model(),
        **{**SGD, **ACOUSTIC_DATA, "train.use_amp": False})
    assert list(cfg["data"]["spk_names"]) == ["Vo1", "S1", "ritsu"]
    start = tmp_path / "start"
    module = init_module(instantiate(cfg["model"]["netG"]), seed=5)
    v = torch_to_flax(module)
    jax_loop.save_checkpoint(start, jax_loop.TrainState(
        v["params"], v["batch_stats"], {}, 0), 0)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        run(side, merge(cfg, {"train": {
            "out_dir": str(dirs[side]),
            "resume": {"checkpoint": str(start / "latest.ckpt")}}}))
    assert_trainers_agree(dirs)
    assert NEPOCHS == 2
