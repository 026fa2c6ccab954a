"""The deterministic NPSS cascade's parts on the port against the JAX
package, on the CPU, at tiny widths: ``Postnet``, ``NonAttentiveDecoder``
and the plain AR decode (``models/tacotron.py``) and
``BiLSTMNonAttentiveDecoder`` (``models/acoustic/tacotron_f0.py``); the
flax-scheme templates of these and of ``NPSSMultistreamParametricModel``
(``models/acoustic/npss.py``, the shape of
``acoustic_npss_ar_mgcf0bap.yaml``, whose forward
``tests/test_torch_npss_cascades.py`` holds).

Weights are the port's, drawn by ``utils/flax_init`` and carried to the JAX
twin with ``torch_to_flax`` (running statistics perturbed away from their
initial values); inputs are seeded NumPy arrays with mixed lengths and an
odd T; the go frame is -4 and r = 2 as shipped.  Prenet dropout 0: masks
cannot match across frameworks.  Teacher-forced outputs and the Post-Net's
updated running statistics at ATOL (float32 on both sides in other
summation orders).  Free-running output is judged by PARITY.md's "AR
parity under chaos" rule: within ATOL of JAX's, or no farther from a
float64 oracle (the port's module in float64) than 3x JAX's own float32
distance from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
    BiLSTMNonAttentiveDecoder,
    NPSSMultistreamParametricModel,
)
from ensemble_svs_with_interactions_tpu_torch.models.tacotron import (
    NonAttentiveDecoder,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    load_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
    init_variables,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)

ATOL = 1e-5
B, T = 3, 23
LENGTHS = np.array([T, T - 6, T - 11])
PKG = "ensemble_svs_with_interactions_tpu.models"
LF0_STATS = {"in_lf0_min": 5.2, "in_lf0_max": 6.6, "out_lf0_mean": 5.9,
             "out_lf0_scale": 0.25}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def decoder_config(out_dim=3, r=2, postnet=2, conv=True, embed=True):
    """``BiLSTMNonAttentiveDecoder`` as the shipped mgc / bap decoders
    (87 inputs: x and lf0; the phoneme block 3..50; r = 2, conv
    downsampling, go frame -4, kaiming init) at tiny widths."""
    net = {"_target_": f"{PKG}.acoustic.BiLSTMNonAttentiveDecoder",
           "in_dim": 87, "out_dim": out_dim, "in_ph_start_idx": 3,
           "in_ph_end_idx": 50, "ff_hidden_dim": 8, "conv_hidden_dim": 6,
           "lstm_hidden_dim": 4, "num_lstm_layers": 1, "decoder_layers": 2,
           "decoder_hidden_dim": 5, "prenet_layers": 0,
           "prenet_hidden_dim": 4, "prenet_dropout": 0.0, "zoneout": 0.0,
           "reduction_factor": r, "downsample_by_conv": conv,
           "postnet_layers": postnet, "postnet_channels": 7,
           "postnet_kernel_size": 5, "postnet_dropout": 0.0,
           "init_type": "kaiming_normal", "initial_value": -4.0}
    if embed:
        net["embed_dim"] = 6
    return net


def cascade_config(vuv_bap=True):
    """``acoustic_npss_ar_mgcf0bap.yaml`` at tiny widths: 86 inputs,
    streams 8 + 1 + 1 + 3, the AR residual-F0 lf0 model (r = 4), the
    Post-Net mgc / bap decoders, the FFConvLSTM vuv model conditioned on
    (mgc, [bap,] lf0)."""
    lf0 = {"_target_": f"{PKG}.acoustic.BiLSTMResF0NonAttentiveDecoder",
           "in_dim": 86, "out_dim": 1, "in_ph_start_idx": 3,
           "in_ph_end_idx": 50, "embed_dim": 6, "ff_hidden_dim": 8,
           "conv_hidden_dim": 6, "lstm_hidden_dim": 4, "num_lstm_layers": 1,
           "decoder_layers": 1, "decoder_hidden_dim": 5, "prenet_layers": 0,
           "prenet_hidden_dim": 4, "prenet_dropout": 0.0,
           "scaled_tanh": True, "zoneout": 0.0, "reduction_factor": 4,
           "downsample_by_conv": True, "in_lf0_idx": 51, "out_lf0_idx": 0,
           **LF0_STATS}
    vuv_in = 86 + 8 + 1 + (3 if vuv_bap else 0)
    net = {"_target_": f"{PKG}.acoustic.NPSSMultistreamParametricModel",
           "in_dim": 86, "out_dim": 13, "stream_sizes": [8, 1, 1, 3],
           "reduction_factor": 4, "in_rest_idx": 0, "in_lf0_idx": 51,
           "out_lf0_idx": 8, **LF0_STATS,
           "vuv_model_bap_conditioning": vuv_bap,
           "vuv_model_bap0_conditioning": False,
           "vuv_model_lf0_conditioning": True,
           "vuv_model_mgc_conditioning": True,
           "lf0_model": lf0, "mgc_model": decoder_config(8),
           "bap_model": decoder_config(3),
           "vuv_model": {"_target_": f"{PKG}.FFConvLSTM", "in_dim": vuv_in,
                         "in_ph_start_idx": 3, "in_ph_end_idx": 50,
                         "embed_dim": 6, "ff_hidden_dim": 8,
                         "conv_hidden_dim": 6, "lstm_hidden_dim": 4,
                         "num_lstm_layers": 1, "bidirectional": True,
                         "out_dim": 1, "dropout": 0.0,
                         "init_type": "kaiming_normal"}}
    return {"netG": net, "stream_sizes": [8, 1, 1, 3],
            "has_dynamic_features": [False] * 4, "num_windows": 1}


def inputs(in_dim, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, T, in_dim)).astype(np.float32)
    x *= (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    return x


def targets(dim, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.normal(size=(B, T, dim)).astype(np.float32)


def twins(net, seed=0):
    """(port module, JAX module, JAX variables): the port's flax-scheme
    weights, running statistics perturbed, carried to JAX."""
    module = init_module(instantiate(net), seed=seed)
    rng = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=rng) * 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=rng) + 0.5)
    return module.eval(), jax_instantiate(net), torch_to_flax(module)


RNGS = {"prenet": jax.random.PRNGKey(0)}


def close(got, want, atol=ATOL):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) or isinstance(got, (tuple, list))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, atol)
        return
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def judge_free_running(got, want, oracle):
    """PARITY.md's rule: ``got`` (the port, float32) within ATOL of JAX's
    float32 ``want``, or no farther from the float64 ``oracle`` than 3x
    JAX's own distance from it."""
    g, w = got.detach().numpy(), np.asarray(want)
    o = oracle.detach().numpy()
    assert g.shape == w.shape == o.shape
    if np.abs(g - w).max() <= ATOL:
        return
    assert np.abs(g - o).max() <= 3 * max(np.abs(w - o).max(), ATOL)


def assert_stats_match(module, updates):
    """The port's running statistics after a training forward against
    JAX's ``batch_stats`` updates."""
    stats = torch_to_flax(module)["batch_stats"]
    for path, value in jax.tree_util.tree_leaves_with_path(
            updates["batch_stats"]):
        node = stats
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(value), rtol=0,
                                   atol=ATOL, err_msg=str(path))


DECODER_CASES = {
    "shipped": decoder_config(),
    "no_postnet_r1": decoder_config(r=1, postnet=0, embed=False),
    "no_conv_r3": decoder_config(r=3, conv=False),
}


@pytest.mark.parametrize("case", sorted(DECODER_CASES))
def test_bilstm_decoder_matches_jax(case):
    """Teacher-forced ``[coarse, fine]`` (or the decoder output without a
    Post-Net), free-running ``inference`` from the go frame -4, and a
    training forward with its batch statistics, all with mixed lengths and
    an odd T."""
    net = DECODER_CASES[case]
    module, jm, variables = twins(net)
    assert module.prediction_type() == PredictionType.DETERMINISTIC
    x, y = inputs(87), targets(net["out_dim"])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    lengths = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        close(module(xt, lengths, y=yt),
              jm.apply(variables, x, LENGTHS, y, rngs=RNGS))
        got = module.inference(xt, lengths)
        oracle = module.double().inference(xt.double(), lengths)
        module.float()
        trained = module(xt, lengths, y=yt, train=True,
                         generator=torch.Generator().manual_seed(0))
    judge_free_running(got, jm.apply(variables, x, LENGTHS,
                                     method=jm.inference, rngs=RNGS),
                       oracle)
    want, updates = jm.apply(variables, x, LENGTHS, y, train=True,
                             rngs=RNGS, mutable=["batch_stats"])
    close(trained, want)
    assert_stats_match(module, updates)


def test_go_frame_is_the_initial_value():
    """The first decoder step is fed ``initial_value``: changing it moves
    the first output of both the teacher-forced and free-running decode,
    and a decoder whose go frame is 0 is not the shipped one's."""
    net = decoder_config(postnet=0, embed=False)
    module = init_module(instantiate(net)).eval()
    zero = init_module(instantiate({**net, "initial_value": 0.0})).eval()
    x = torch.from_numpy(inputs(87, seed=3))
    y = torch.from_numpy(targets(3, seed=3))
    with torch.no_grad():
        for kw in ({"y": y}, {}):
            a, b = module(x, **kw), zero(x, **kw)
            assert not torch.allclose(a[:, :2], b[:, :2])
    assert module.ar_core.initial_value == -4.0


def test_nonattentive_decoder_matches_jax():
    """``NonAttentiveDecoder`` over encoder outputs: teacher-forced and
    free-running, with its Post-Net."""
    net = {"_target_": f"{PKG}.tacotron.NonAttentiveDecoder", "in_dim": 10,
           "out_dim": 4, "layers": 1, "hidden_dim": 6, "prenet_layers": 0,
           "prenet_dropout": 0.0, "zoneout": 0.0, "reduction_factor": 2,
           "downsample_by_conv": True, "initial_value": 1.5,
           "postnet_layers": 3, "postnet_channels": 5,
           "postnet_kernel_size": 3}
    module, jm, variables = twins(net)
    assert isinstance(module, NonAttentiveDecoder)
    x, y = inputs(10, seed=4), targets(4, seed=4)
    with torch.no_grad():
        close(module(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                     y=torch.from_numpy(y)),
              jm.apply(variables, x, LENGTHS, y, rngs=RNGS))
        close(module.inference(torch.from_numpy(x)),
              jm.apply(variables, x, method=jm.inference, rngs=RNGS))


TEMPLATE_CASES = {
    "decoder": decoder_config(),
    "decoder_r1": decoder_config(r=1, postnet=0, embed=False),
    "cascade": cascade_config()["netG"],
}


@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_flax_init_templates_match_jax(case):
    """``init_variables`` gives the JAX ``init``'s tree (every path and
    shape, params and batch statistics: the Post-Net's ``conv{i}`` /
    ``bn{i}``, the decoder's ``ar_core``), so stage 6 restores a
    checkpoint onto it; the encoder's Dense kernels follow
    ``init_type``."""
    net = TEMPLATE_CASES[case]
    got = init_variables(instantiate(net), seed=0)
    jm = jax_instantiate(net)
    want = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "prenet": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 8, net["in_dim"])), jnp.array([8])))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(want))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == shapes
    if case == "decoder":
        kernel = got["params"]["_SinsyEncoder_0"]["Dense_1"]["kernel"]
        assert 0.5 < kernel.var() / (2.0 / kernel.shape[0]) < 1.5


def test_shipped_config_builds_in_the_port():
    """``instantiate`` builds ``acoustic_npss_ar_mgcf0bap.yaml`` (its lf0
    statistics filled as the runner fills them) into the port's classes,
    at the shipped widths: the mgc decoder's cells at H = 1024."""
    from tests.test_torch_npss_mdn import shipped_netg

    module = instantiate(shipped_netg("acoustic_npss_ar_mgcf0bap.yaml"))
    assert isinstance(module, NPSSMultistreamParametricModel)
    assert isinstance(module.mgc_model, BiLSTMNonAttentiveDecoder)
    assert module.mgc_model.ar_core.cell0.w_h.shape == (1024, 4096)
    assert module.mgc_model.ar_core.initial_value == -4.0
    assert module.bap_model.postnet.layers == 5


def test_config_yaml_reads():
    """The shipped file reads with the port's YAML subset."""
    from tests.test_torch_npss_mdn import CONFIGS

    cfg = load_config(CONFIGS / "acoustic_npss_ar_mgcf0bap.yaml")
    assert cfg.netG.mgc_model.decoder_hidden_dim == 1024
