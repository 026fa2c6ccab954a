"""The NPSS-MDN cascade, ``NPSSMDNMultistreamParametricModel``
(``acoustic_npss_mdn.yaml``), whole on the port against the JAX package,
on the CPU, at the tiny widths of ``tests/test_torch_npss_mdn.py``:
teacher-forced and free-running outputs at ATOL, and one
``create_train_step`` step (``tests/test_torch_trainer.
assert_step_matches_jax``: the metrics at 1e-5 relative, every gradient
within 1e-5 of its scale) from the port's flax-scheme weights, its loss
the multistream loss over the per-stream outputs (MDN NLL for mgc and
bap) plus ``pitch_reg_weight`` times the lf0 residual's.
"""

import pytest
import torch

from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_npss_ar import LENGTHS, close, inputs, targets, twins
from tests.test_torch_npss_mdn import cascade_config as mdn_cascade_config
from tests.test_torch_npss_steps import step_batch
from tests.test_torch_trainer import assert_step_matches_jax


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_npss_mdn_cascade_matches_jax():
    """Teacher-forced (``((mgc, lf0, vuv, bap), lf0 residual)``, the MDN
    streams as parameter tuples) and free-running (the point estimates
    concatenated, ``inference``), V/UV on (x, lf0, bap)."""
    net = mdn_cascade_config()["netG"]
    module, jm, variables = twins(net)
    assert module.prediction_type() == PredictionType.MULTISTREAM_HYBRID
    x, y = inputs(86, seed=3), targets(13, seed=3)
    xt, lengths = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        got = module(xt, lengths, y=torch.from_numpy(y))
        assert len(got[0][0]) == 3  # mgc's MDN parameters
        close(got, jm.apply(variables, x, LENGTHS, y))
        close(module(xt, lengths), jm.apply(variables, x, LENGTHS))
        close(module.inference(xt, lengths),
              jm.apply(variables, x, LENGTHS, method=jm.inference))


def test_train_step_matches_jax():
    """One step of the MDN cascade with the pitch regularization on."""
    cfg = mdn_cascade_config()
    variables = torch_to_flax(init_module(instantiate(cfg["netG"])))
    assert_step_matches_jax(cfg, dict(pitch_reg_weight=1.0), step_batch(cfg),
                            variables)
