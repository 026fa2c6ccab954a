"""Residual-F0 variants of generic backbones (``ResF0Conv1dResnet`` of
``ensemble_svs_with_interactions_tpu/models/acoustic/resf0.py``): the
backbone runs, then its lf0 output column is replaced by the score lf0
plus a tanh-bounded residual, and ``(out, lf0_residual)`` is returned.
"""

from __future__ import annotations

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
    predict_lf0_with_residual,
    set_lf0_column,
)
from ensemble_svs_with_interactions_tpu_torch.models.generic import (
    _Conv1dResnetBody,
)
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    MDNLayer,
    mdn_get_most_probable_sigma_and_mu,
)


class _ResF0Mixin:
    """What the residual-F0 backbones share: the prediction type, the lf0
    column's replacement and ``inference``."""

    def has_residual_lf0_prediction(self):
        return True

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def _finalize(self, x, mu):
        lf0_pred, lf0_residual = predict_lf0_with_residual(
            x, mu, self.in_lf0_idx, self.in_lf0_min, self.in_lf0_max,
            self.out_lf0_idx, self.out_lf0_mean, self.out_lf0_scale)
        return set_lf0_column(mu, lf0_pred, self.out_lf0_idx), lf0_residual

    def inference(self, x, lengths=None):
        if self.use_mdn:
            (log_pi, log_sigma, mu), _ = self(x, lengths)
            sigma, mu = mdn_get_most_probable_sigma_and_mu(log_pi, log_sigma,
                                                           mu)
            return mu, sigma
        return self(x, lengths)[0]


class ResF0Conv1dResnet(_ResF0Mixin, BaseModel, _Conv1dResnetBody):
    """``Conv1dResnet`` with residual F0: ``forward`` gives ``(mu,
    lf0_residual)``, or ``((log_pi, log_sigma, mu), lf0_residual)`` with
    ``use_mdn`` (every component's mean takes the residual).  Its two k7
    kernels take ``init_type``, as the JAX model passes them its
    ``kernel_init``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 4, in_lf0_idx: int = 300,
                 in_lf0_min: float = 5.3936276, in_lf0_max: float = 6.491111,
                 out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 init_type: str = "none", use_mdn: bool = False,
                 num_gaussians: int = 8, dim_wise: bool = False):
        super().__init__()
        self.in_lf0_idx, self.out_lf0_idx = in_lf0_idx, out_lf0_idx
        self.in_lf0_min, self.in_lf0_max = in_lf0_min, in_lf0_max
        self.out_lf0_mean, self.out_lf0_scale = out_lf0_mean, out_lf0_scale
        self.init_type, self.use_mdn = init_type, use_mdn
        self._add_body(in_dim, hidden_dim,
                       hidden_dim if use_mdn else out_dim, num_layers,
                       init_type)
        self.MDNLayer_0 = (MDNLayer(hidden_dim, out_dim, num_gaussians,
                                    dim_wise) if use_mdn else None)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = self._body(x)
        if self.use_mdn:
            log_pi, log_sigma, mu = self.MDNLayer_0(h)
            mu, lf0_residual = self._finalize(x, mu)
            return (log_pi, log_sigma, mu), lf0_residual
        return self._finalize(x, h)
