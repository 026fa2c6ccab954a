"""Sinsy-style acoustic model with residual F0 prediction
(``ResSkipF0FFConvLSTM`` of ``ensemble_svs_with_interactions_tpu/models/
acoustic/sinsy.py``): FF stack, the score lf0 concatenated, Conv (+ masked
BN) stack, biLSTM (the port's recurrence kernels on the card), an optional
skip of the inputs, a linear or MDN head, and the head's lf0 column
replaced by the score lf0 plus a bounded residual.
"""

from __future__ import annotations

import torch
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
    predict_lf0_with_residual,
    set_lf0_column,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    LSTM,
    MaskedBatchNorm,
    ReflectConv1d,
    time_mask,
)
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    MDNLayer,
    mdn_get_most_probable_sigma_and_mu,
)


class ResSkipF0FFConvLSTM(BaseModel):
    """FFN + Conv1d + LSTM with residual F0 and optional skip connections.

    ``forward`` returns ``(mu, lf0_residual)``, or ``((log_pi, log_sigma,
    mu), lf0_residual)`` with ``use_mdn``; ``inference`` the prediction
    (``(mu, sigma)`` of the most probable component with ``use_mdn``)."""

    def __init__(self, in_dim: int, ff_hidden_dim: int = 2048,
                 conv_hidden_dim: int = 1024, lstm_hidden_dim: int = 256,
                 out_dim: int = 199, dropout: float = 0.0,
                 num_lstm_layers: int = 2, bidirectional: bool = True,
                 in_lf0_idx: int = 300, in_lf0_min: float = 5.3936276,
                 in_lf0_max: float = 6.491111, out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 skip_inputs: bool = False, init_type: str = "none",
                 use_mdn: bool = False, num_gaussians: int = 8,
                 dim_wise: bool = False):
        super().__init__()
        self.in_lf0_idx, self.out_lf0_idx = in_lf0_idx, out_lf0_idx
        self.lf0_stats = dict(in_lf0_min=in_lf0_min, in_lf0_max=in_lf0_max,
                              out_lf0_mean=out_lf0_mean,
                              out_lf0_scale=out_lf0_scale)
        self.skip_inputs, self.use_mdn = skip_inputs, use_mdn
        self.init_type = init_type
        for i in range(3):
            setattr(self, f"Dense_{i}",
                    nn.Linear(in_dim if i == 0 else ff_hidden_dim,
                              ff_hidden_dim))
        for i in range(3):
            setattr(self, f"ReflectConv1d_{i}",
                    ReflectConv1d(ff_hidden_dim + 1 if i == 0
                                  else conv_hidden_dim, conv_hidden_dim, 7,
                                  init_type=init_type))
            setattr(self, f"MaskedBatchNorm_{i}",
                    MaskedBatchNorm(conv_hidden_dim))
        self.LSTM_0 = LSTM(conv_hidden_dim, lstm_hidden_dim,
                           num_layers=num_lstm_layers,
                           bidirectional=bidirectional, dropout=dropout)
        head_in = self.LSTM_0.out_dim + (in_dim if skip_inputs else 0)
        if use_mdn:
            self.MDNLayer_0 = MDNLayer(head_in, out_dim, num_gaussians,
                                       dim_wise)
        else:
            self.Dense_3 = nn.Linear(head_in, out_dim)

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def has_residual_lf0_prediction(self):
        return True

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        lf0_score = x[:, :, self.in_lf0_idx][..., None]
        h = x
        for i in range(3):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        h = torch.cat([h, lf0_score], dim=-1)
        mask = time_mask(lengths, h.shape[1], h.device)
        for i in range(3):
            h = getattr(self, f"ReflectConv1d_{i}")(h)
            h = torch.relu(getattr(self, f"MaskedBatchNorm_{i}")(
                h, mask=mask, train=train))
        h = self.LSTM_0(h, lengths, train, generator)
        if self.skip_inputs:
            h = torch.cat([h, x], dim=-1)
        if self.use_mdn:
            log_pi, log_sigma, mu = self.MDNLayer_0(h)
        else:
            mu = self.Dense_3(h)
        lf0_pred, lf0_residual = predict_lf0_with_residual(
            x, mu, self.in_lf0_idx, out_lf0_idx=self.out_lf0_idx,
            **self.lf0_stats)
        mu = set_lf0_column(mu, lf0_pred, self.out_lf0_idx)
        if self.use_mdn:
            return (log_pi, log_sigma, mu), lf0_residual
        return mu, lf0_residual

    def inference(self, x, lengths=None):
        if self.use_mdn:
            (log_pi, log_sigma, mu), _ = self(x, lengths)
            sigma, mu = mdn_get_most_probable_sigma_and_mu(log_pi, log_sigma,
                                                           mu)
            return mu, sigma
        return self(x, lengths)[0]
