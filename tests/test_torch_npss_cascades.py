"""The deterministic single-track NPSS cascade,
``NPSSMultistreamParametricModel`` (``acoustic_npss_ar_mgcf0bap.yaml``),
whole, on the port against the JAX package, on the CPU, at the tiny widths
of ``tests/test_torch_npss_ar.py``, whose weights, inputs and judges it
uses: outputs at ATOL, free-running output by PARITY.md's "AR parity under
chaos" rule.
"""

import pytest
import torch

from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from tests.test_torch_npss_ar import (
    LENGTHS,
    RNGS,
    assert_stats_match,
    cascade_config,
    close,
    inputs,
    judge_free_running,
    targets,
    twins,
)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vuv_bap", [False, True])
def test_npss_cascade_matches_jax(vuv_bap):
    """The cascade teacher-forced (``([coarse, fine], lf0 residual)``,
    evaluation and training with batch statistics) and free-running
    (``inference``: the fine streams), V/UV conditioned on (mgc, [bap,]
    lf0) in the deterministic cascade's order."""
    net = cascade_config(vuv_bap)["netG"]
    module, jm, variables = twins(net)
    assert module.has_residual_lf0_prediction()
    assert module.prediction_type() == PredictionType.DETERMINISTIC
    x, y = inputs(86, seed=5), targets(13, seed=5)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    lengths = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        got = module(xt, lengths, y=yt)
        assert isinstance(got[0], list) and len(got[0]) == 2
        close(got, jm.apply(variables, x, LENGTHS, y, rngs=RNGS))
        free = module.inference(xt, lengths)
        oracle = module.double().inference(xt.double(), lengths)
        module.float()
        trained = module(xt, lengths, y=yt, train=True,
                         generator=torch.Generator().manual_seed(0))
    judge_free_running(free, jm.apply(variables, x, LENGTHS,
                                      method=jm.inference, rngs=RNGS),
                       oracle)
    want, updates = jm.apply(variables, x, LENGTHS, y, train=True,
                             rngs=RNGS, mutable=["batch_stats"])
    close(trained, want)
    assert_stats_match(module, updates)
