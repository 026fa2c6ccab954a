"""``utils/flax_init`` against the JAX trainers' ``module.init`` on the
CPU: over 8 seeds each constant tensor equals JAX's exactly, and each
random tensor of 1,000 entries or more has its std within 10% of JAX's
and its mean within 4 standard errors; the module takes the draws.
"""

import jax
import numpy as np
import pytest
from flax import traverse_util

import chip_smoke
from ensemble_svs_with_interactions_tpu.train import (
    multitrack_trainer as jax_mt_trainer,
)
from ensemble_svs_with_interactions_tpu.utils.config import _wrap
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_init
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

SEEDS = 8


def _flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


def _init_models():
    """(name, netG config, acoustic?) of the multitrack models the
    trainers build, at widths where most tensors hold 1,000 entries or
    more.  Their classes carry every scheme: the single-track voice's
    encoder and decoders are the same layers by other names."""
    mt, _ = chip_smoke.flagship_acoustic_config(3, tiny=True)
    net = mt["netG"]
    net["encoder"].update(hidden_dim=32, out_dim=64, embed_dim=32)
    net["lf0_model"].update(embed_dim=32, ff_hidden_dim=32,
                            conv_hidden_dim=32, lstm_hidden_dim=32,
                            decoder_hidden_dim=32)
    for k in ("mgc_model", "vuv_model", "bap_model"):
        net[k].update(in_dim=66, ff_hidden_dim=32, conv_hidden_dim=32,
                      lstm_hidden_dim=32)
    net["speaker_embedding"]["embedding_dim"] = 32
    duration = chip_smoke.shipped_config(
        "duration/multitrack_duration_vp_mdn.yaml")["netG"]
    return [("multitrack_acoustic", net, True),
            ("multitrack_duration", duration, False)]


@pytest.mark.parametrize("name,net,acoustic", _init_models(),
                         ids=[m[0] for m in _init_models()])
def test_flax_init_draws_the_flax_schemes(name, net, acoustic):
    jm = jax_instantiate(net)
    cfg = _wrap({"model": {"netG": net}})
    init = jax.jit(lambda s: jax_mt_trainer._init_multitrack_variables(
        jm, cfg, acoustic, seed=s))
    ref, got = {}, {}
    for seed in range(SEEDS):
        v = init(seed)
        for k, x in _flat(jax.tree_util.tree_map(np.asarray,
                                                 dict(v))).items():
            ref.setdefault(k, []).append(x)
        port = flax_init.init_variables(instantiate(net), seed)
        for k, x in _flat(port).items():
            got.setdefault(k, []).append(x)
    assert sorted(got) == sorted(ref)
    checked = 0
    for k, r in ref.items():
        r, g = np.stack(r).astype(np.float64), np.stack(got[k])
        assert g.shape == r.shape and g.dtype == np.float32, k
        if (r == r.flat[0]).all():
            assert np.array_equal(g, r.astype(np.float32)), k
            continue
        assert not (g == g.flat[0]).all(), k
        if r[0].size < 1000:
            continue
        checked += 1
        assert abs(g.std() / r.std() - 1) < 0.1, (k, g.std(), r.std())
        se = np.sqrt(g.var() / g.size + r.var() / r.size)
        assert abs(g.mean() - r.mean()) < 4 * se, (k, g.mean(), r.mean())
    assert checked >= (10 if acoustic else 2)
    # the module takes the draws, and torch_to_flax gives them back
    module = flax_init.init_module(instantiate(net), 5)
    again = _flat(torch_to_flax(module))
    for k, x in _flat(flax_init.init_variables(instantiate(net), 5)).items():
        assert np.array_equal(again[k], x), k
