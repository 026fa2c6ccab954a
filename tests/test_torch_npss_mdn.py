"""The NPSS-MDN cascade's parts on the port against the JAX package, on
the CPU, at tiny widths: ``Conv1dResnet`` (plain, with an MDN head, with a
phoneme embedding) and ``Conv1dResnetMDN`` (``models/generic.py``) and
``ResF0Conv1dResnet`` (``models/acoustic/resf0.py``); the flax-scheme
templates of these and of ``NPSSMDNMultistreamParametricModel``
(``models/acoustic/npss.py``, the shape of ``acoustic_npss_mdn.yaml``,
whose forward ``tests/test_torch_npss_cascades.py`` holds).

Weights, inputs and tolerances as ``tests/test_torch_npss_ar.py``: the
port's flax-scheme weights carried to JAX by ``torch_to_flax``, seeded
NumPy inputs with mixed lengths, outputs at ATOL.  These models have no
dropout, batch norm or feedback, so training changes nothing in their
forward.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.models import (
    Conv1dResnet,
    Conv1dResnetMDN,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
    NPSSMDNMultistreamParametricModel,
    ResF0Conv1dResnet,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    load_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_variables,
)
from tests.test_torch_npss_ar import (
    LF0_STATS,
    PKG,
    close,
    inputs,
    twins,
)

CONFIGS = Path(__file__).resolve().parent.parent / (
    "ensemble_svs_with_interactions_tpu/configs/acoustic")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def shipped_netg(name):
    """A shipped acoustic config's ``netG`` with its null lf0 statistics
    filled, as the recipe runner's ``_resolve_lf0_stats`` fills them."""
    def fill(node):
        if isinstance(node, dict):
            return {k: LF0_STATS[k] if k in LF0_STATS and v is None
                    else fill(v) for k, v in node.items()}
        return node

    return fill(dict(load_config(CONFIGS / name).netG))


def resnet_config(cls="Conv1dResnet", in_dim=87, out_dim=3, use_mdn=True,
                  embed=False, **kw):
    net = {"_target_": f"{PKG}.{cls}", "in_dim": in_dim, "hidden_dim": 8,
           "out_dim": out_dim, "num_layers": 3, "num_gaussians": 2,
           "dim_wise": True, **kw}
    if cls == "Conv1dResnet":
        net["use_mdn"] = use_mdn
    if embed:
        net.update(embed_dim=6, in_ph_start_idx=3, in_ph_end_idx=50)
    return net


def resf0_config(use_mdn=False):
    return {"_target_": f"{PKG}.acoustic.ResF0Conv1dResnet", "in_dim": 86,
            "hidden_dim": 8, "out_dim": 2, "num_layers": 2,
            "in_lf0_idx": 51, "out_lf0_idx": 1, "use_mdn": use_mdn,
            "num_gaussians": 2, "dim_wise": True,
            "init_type": "kaiming_normal", **LF0_STATS}


def cascade_config():
    """``acoustic_npss_mdn.yaml`` at tiny widths: 86 inputs, streams
    8 + 1 + 1 + 3, the ResF0Conv1dResnet lf0 model, Conv1dResnet MDN mgc
    and bap models, a Conv1dResnet vuv model on (x, lf0, bap)."""
    lf0 = {**resf0_config(), "out_dim": 1, "out_lf0_idx": 0}
    net = {"_target_": f"{PKG}.acoustic.NPSSMDNMultistreamParametricModel",
           "in_dim": 86, "out_dim": 13, "stream_sizes": [8, 1, 1, 3],
           "reduction_factor": 1, "in_rest_idx": 0, "in_lf0_idx": 51,
           "out_lf0_idx": 8, **LF0_STATS, "lf0_model": lf0,
           "mgc_model": resnet_config(out_dim=8),
           "bap_model": resnet_config(out_dim=3),
           "vuv_model": resnet_config(in_dim=86 + 1 + 3, out_dim=1,
                                      use_mdn=False)}
    return {"netG": net, "stream_sizes": [8, 1, 1, 3],
            "has_dynamic_features": [False] * 4, "num_windows": 1}


RESNET_CASES = {
    "plain": resnet_config(use_mdn=False),
    "mdn": resnet_config(),
    "mdn_embed": resnet_config(embed=True, dim_wise=False),
    "Conv1dResnetMDN": resnet_config("Conv1dResnetMDN"),
}


@pytest.mark.parametrize("case", sorted(RESNET_CASES))
def test_conv1d_resnet_matches_jax(case):
    """Forward (the output, or ``(log_pi, log_sigma, mu)``) and
    ``inference`` (the output, or ``(mu, sigma)``)."""
    net = RESNET_CASES[case]
    module, jm, variables = twins(net)
    assert isinstance(module, Conv1dResnetMDN if "MDN" in case
                      else Conv1dResnet)
    mdn = case != "plain"
    assert module.prediction_type() == (
        PredictionType.PROBABILISTIC if mdn else PredictionType.DETERMINISTIC)
    x = inputs(87, seed=1)
    with torch.no_grad():
        close(module(torch.from_numpy(x)), jm.apply(variables, x))
        close(module.inference(torch.from_numpy(x)),
              jm.apply(variables, x, method=jm.inference))


@pytest.mark.parametrize("use_mdn", [False, True])
def test_resf0_conv1d_resnet_matches_jax(use_mdn):
    """``(prediction, lf0 residual)`` and ``inference``: the lf0 column
    (every component's mean under MDN) is the score lf0 plus the bounded
    residual."""
    net = resf0_config(use_mdn)
    module, jm, variables = twins(net)
    assert module.has_residual_lf0_prediction()
    x = inputs(86, seed=2)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
        close(got, jm.apply(variables, x))
        close(module.inference(torch.from_numpy(x)),
              jm.apply(variables, x, method=jm.inference))
    assert got[1].abs().max() <= 600 * np.log(2) / 1200


TEMPLATE_CASES = {
    "Conv1dResnet_mdn_embed": RESNET_CASES["mdn_embed"],
    "ResF0Conv1dResnet_mdn": resf0_config(True),
    "cascade": cascade_config()["netG"],
}


@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_flax_init_templates_match_jax(case):
    """``init_variables`` gives the JAX ``init``'s tree (the weight norms'
    ``WeightNorm_{k}`` scales beside their ``Conv_{k}``, the MDN heads);
    ``ResF0Conv1dResnet``'s k7 kernels follow its ``init_type``."""
    net = TEMPLATE_CASES[case]
    got = init_variables(instantiate(net), seed=0)
    jm = jax_instantiate(net)
    want = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, net["in_dim"])),
        jnp.array([16])))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(want))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == shapes
    if case == "ResF0Conv1dResnet_mdn":
        kernel = got["params"]["ReflectConv1d_0"]["Conv_0"]["kernel"]
        fan_in = kernel.shape[0] * kernel.shape[1]
        assert 0.5 < kernel.var() / (2.0 / fan_in) < 1.5
        scale = got["params"]["ReflectConv1d_0"]["WeightNorm_0"]
        np.testing.assert_array_equal(scale["Conv_0/kernel/scale"], 1.0)


def test_shipped_config_builds_in_the_port():
    """``instantiate`` builds ``acoustic_npss_mdn.yaml`` into the port's
    classes at the shipped widths."""
    module = instantiate(shipped_netg("acoustic_npss_mdn.yaml"))
    assert isinstance(module, NPSSMDNMultistreamParametricModel)
    assert isinstance(module.lf0_model, ResF0Conv1dResnet)
    assert module.mgc_model.use_mdn and not module.vuv_model.use_mdn
    assert sum(p.numel() for p in module.parameters()) == 3137842
