"""Residual-F0 variants of generic backbones (``ResF0Conv1dResnet``,
``ResF0VariancePredictor`` and ``ResF0TransformerEncoder`` of
``ensemble_svs_with_interactions_tpu/models/acoustic/resf0.py``): the
backbone runs, then its lf0 output column is replaced by the score lf0
plus a tanh-bounded residual, and ``(out, lf0_residual)`` is returned.
"""

from __future__ import annotations

from typing import Optional

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
    predict_lf0_with_residual,
    set_lf0_column,
)
from ensemble_svs_with_interactions_tpu_torch.models.generic import (
    TransformerEncoder,
    _add_conv_ln_stack,
    _Conv1dResnetBody,
    _conv_ln_stack,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    PhonemeContextEmbedding,
)
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    MDNLayer,
    mdn_get_most_probable_sigma_and_mu,
)


class _ResF0Mixin:
    """What the residual-F0 backbones share: the lf0 fields, the
    prediction type, the lf0 column's replacement and ``inference``."""

    def has_residual_lf0_prediction(self):
        return True

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def _lf0_fields(self, in_lf0_idx, in_lf0_min, in_lf0_max, out_lf0_idx,
                    out_lf0_mean, out_lf0_scale):
        self.in_lf0_idx, self.out_lf0_idx = in_lf0_idx, out_lf0_idx
        self.in_lf0_min, self.in_lf0_max = in_lf0_min, in_lf0_max
        self.out_lf0_mean, self.out_lf0_scale = out_lf0_mean, out_lf0_scale

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
        self._lf0_fields(in_lf0_idx, in_lf0_min, in_lf0_max, out_lf0_idx,
                         out_lf0_mean, out_lf0_scale)
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


class ResF0VariancePredictor(_ResF0Mixin, BaseModel):
    """``VariancePredictor`` with residual F0: an optional phoneme
    embedding, ``num_layers`` x (conv, ReLU, LayerNorm eps 1e-12, dropout
    in training), a linear (``Dense_0``) or MDN head; ``forward`` gives
    ``(mu, lf0_residual)`` or ``((log_pi, log_sigma, mu),
    lf0_residual)``."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 5,
                 hidden_dim: int = 256, kernel_size: int = 5,
                 dropout: float = 0.5, in_lf0_idx: int = 300,
                 in_lf0_min: float = 5.3936276, in_lf0_max: float = 6.491111,
                 out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 init_type: str = "none", use_mdn: bool = False,
                 num_gaussians: int = 1, dim_wise: bool = False,
                 in_ph_start_idx: int = 1, in_ph_end_idx: int = 50,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self._lf0_fields(in_lf0_idx, in_lf0_min, in_lf0_max, out_lf0_idx,
                         out_lf0_mean, out_lf0_scale)
        self.init_type, self.use_mdn = init_type, use_mdn
        width = in_dim
        self.PhonemeContextEmbedding_0 = None
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        _add_conv_ln_stack(self, width, out_dim, num_layers, hidden_dim,
                           kernel_size, use_mdn, num_gaussians, dim_wise,
                           dropout)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = x
        if self.PhonemeContextEmbedding_0 is not None:
            h = self.PhonemeContextEmbedding_0(h)
        out = _conv_ln_stack(self, h, train, generator)
        if self.use_mdn:
            log_pi, log_sigma, mu = out
            mu, lf0_residual = self._finalize(x, mu)
            return (log_pi, log_sigma, mu), lf0_residual
        return self._finalize(x, out)


class ResF0TransformerEncoder(_ResF0Mixin, BaseModel):
    """``TransformerEncoder`` (``TransformerEncoder_0``) with residual F0,
    the prediction truncated to the input's length (the reduction factor
    rounds it down).  It has no MDN head, as in the JAX package."""

    use_mdn = False

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 attention_dim: int, num_heads: int = 2, num_layers: int = 2,
                 kernel_size: int = 3, dropout: float = 0.1,
                 reduction_factor: int = 1, init_type: str = "none",
                 downsample_by_conv: bool = False, in_lf0_idx: int = 300,
                 in_lf0_min: float = 5.3936276, in_lf0_max: float = 6.491111,
                 out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034):
        super().__init__()
        self._lf0_fields(in_lf0_idx, in_lf0_min, in_lf0_max, out_lf0_idx,
                         out_lf0_mean, out_lf0_scale)
        self.TransformerEncoder_0 = TransformerEncoder(
            in_dim, out_dim, hidden_dim, attention_dim, num_heads=num_heads,
            num_layers=num_layers, kernel_size=kernel_size, dropout=dropout,
            reduction_factor=reduction_factor, init_type=init_type,
            downsample_by_conv=downsample_by_conv)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        mu = self.TransformerEncoder_0(x, lengths, train=train,
                                       generator=generator)
        T = min(x.shape[1], mu.shape[1])
        return self._finalize(x[:, :T], mu[:, :T])
