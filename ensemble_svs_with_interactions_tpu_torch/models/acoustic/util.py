"""Point estimates of sub-model outputs (``point_estimate`` of
``ensemble_svs_with_interactions_tpu/models/acoustic/util.py``)."""

from __future__ import annotations

from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    mdn_get_most_probable_sigma_and_mu,
)


def point_estimate(pred):
    """MDN heads' ``(log_pi, log_sigma, mu)`` -> most probable mean; AR MDN
    ``(mu, sigma)`` -> mu; Post-Net ``[coarse, fine]`` -> fine; arrays as
    they are."""
    if isinstance(pred, list):
        pred = pred[-1]
    if isinstance(pred, tuple) and len(pred) == 3:
        return mdn_get_most_probable_sigma_and_mu(*pred)[1]
    if isinstance(pred, tuple) and len(pred) == 2:
        return pred[0]
    return pred
