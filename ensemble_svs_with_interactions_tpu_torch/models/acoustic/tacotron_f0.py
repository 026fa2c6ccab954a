"""The interaction F0 model: ``MultiTrackBiLSTMResF0NonAttentiveDecoder``
and its ``_SinsyEncoder`` (counterparts in
``ensemble_svs_with_interactions_tpu/models/acoustic/tacotron_f0.py``).

Both tracks go through a shared phoneme embedding, get their speaker
embeddings added and are summed; an FF -> Conv(+BN) -> biLSTM encoder sees
both score-lf0 tracks, and the AR residual-F0 decoder predicts the main
track's lf0 around its score.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    LSTM,
    MaskedBatchNorm,
    PhonemeContextEmbedding,
    ReflectConv1d,
    time_mask,
)
from ensemble_svs_with_interactions_tpu_torch.models.tacotron import (
    _ARDecoderCore,
    ar_decode,
)


class _SinsyEncoder(nn.Module):
    """FF x3 -> concat(lf0 scores) -> (Conv k7 + BN + ReLU) x3 -> biLSTM."""

    def __init__(self, in_dim: int, ff_hidden_dim: int, conv_hidden_dim: int,
                 lstm_hidden_dim: int, num_lstm_layers: int, dropout: float,
                 num_lf0_scores: int):
        super().__init__()
        for i in range(3):
            setattr(self, f"Dense_{i}",
                    nn.Linear(in_dim if i == 0 else ff_hidden_dim,
                              ff_hidden_dim))
        for i in range(3):
            setattr(self, f"ReflectConv1d_{i}",
                    ReflectConv1d(ff_hidden_dim + num_lf0_scores if i == 0
                                  else conv_hidden_dim, conv_hidden_dim, 7))
            setattr(self, f"MaskedBatchNorm_{i}",
                    MaskedBatchNorm(conv_hidden_dim))
        self.LSTM_0 = LSTM(conv_hidden_dim, lstm_hidden_dim,
                           num_layers=num_lstm_layers, bidirectional=True,
                           dropout=dropout)

    def forward(self, x, lf0_scores, lengths=None, train: bool = False,
                generator=None):
        h = x
        for i in range(3):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        h = torch.cat([h] + list(lf0_scores), dim=-1)
        mask = time_mask(lengths, h.shape[1], h.device)
        for i in range(3):
            h = getattr(self, f"ReflectConv1d_{i}")(h)
            h = torch.relu(getattr(self, f"MaskedBatchNorm_{i}")(
                h, mask=mask, train=train))
        return self.LSTM_0(h, lengths, train, generator)


class MultiTrackBiLSTMResF0NonAttentiveDecoder(BaseModel):
    """The interaction F0 model (decoder ``in_lf0_idx = -2``: the main
    track's score lf0).  Ported: the flagship's decoder (no prenet, no
    zoneout, no MDN head, conv downsampling by r > 1); other settings
    raise (zoneout's training masks would put the cell state back in a
    per-step loop).  Without targets ``y`` it decodes free-running; with
    them it is teacher-forced.  The prenet dropout on the fed-back frame
    applies in both, the encoder's dropout only with ``train=True``."""

    def __init__(self, in_dim: int = 512, ff_hidden_dim: int = 2048,
                 conv_hidden_dim: int = 1024, lstm_hidden_dim: int = 256,
                 num_lstm_layers: int = 2, dropout: float = 0.0,
                 out_dim: int = 1, decoder_layers: int = 2,
                 decoder_hidden_dim: int = 1024, prenet_layers: int = 2,
                 prenet_hidden_dim: int = 256, prenet_dropout: float = 0.5,
                 zoneout: float = 0.1, reduction_factor: int = 1,
                 downsample_by_conv: bool = False, scaled_tanh: bool = True,
                 in_lf0_idx: int = 300, in_lf0_min: float = 5.3936276,
                 in_lf0_max: float = 6.491111, out_lf0_idx: int = 0,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 use_mdn: bool = False, num_gaussians: int = 4,
                 sampling_mode: str = "mean", in_ph_start_idx: int = 1,
                 in_ph_end_idx: int = 50, embed_dim: Optional[int] = None,
                 init_type: str = "none", eval_dropout: bool = True,
                 num_speaker: Optional[int] = None):
        super().__init__()
        if (prenet_layers > 0 or zoneout > 0 or use_mdn or not scaled_tanh
                or not eval_dropout or reduction_factor < 2
                or not downsample_by_conv):
            raise NotImplementedError(
                "the port's AR F0 decoder covers the flagship configuration "
                "(prenet_layers=0, zoneout=0, use_mdn=False, "
                "scaled_tanh=True, eval_dropout=True, reduction_factor > 1 "
                "with downsample_by_conv)")
        self.in_lf0_idx = in_lf0_idx
        self.in_lf0_min, self.in_lf0_max = in_lf0_min, in_lf0_max
        self.reduction_factor = reduction_factor
        width = in_dim
        if embed_dim is not None:
            self.shared_ph_embed = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        else:
            self.shared_ph_embed = None
        self._SinsyEncoder_0 = _SinsyEncoder(
            width, ff_hidden_dim, conv_hidden_dim, lstm_hidden_dim,
            num_lstm_layers, dropout, num_lf0_scores=2)
        C = self._SinsyEncoder_0.LSTM_0.out_dim + 2
        self.conv_downsample = nn.Conv1d(C, C, reduction_factor,
                                         stride=reduction_factor, groups=C)
        self.ar_core = _ARDecoderCore(
            C, out_dim, decoder_layers, decoder_hidden_dim, prenet_dropout,
            reduction_factor, out_lf0_idx, float(out_lf0_mean),
            float(out_lf0_scale))

    def prediction_type(self):
        return PredictionType.DETERMINISTIC

    def encode(self, x_main, x_sub, spk_emb_main=None, spk_emb_sub=None,
               lengths=None, train: bool = False, generator=None):
        """The non-autoregressive front: (B, T, 2 * lstm_hidden + 2)
        encoder features ending in the main and sub score lf0."""
        lf0_main = x_main[:, :, self.in_lf0_idx][..., None]
        lf0_sub = x_sub[:, :, self.in_lf0_idx][..., None]
        if self.shared_ph_embed is not None:
            x_main = self.shared_ph_embed(x_main)
            x_sub = self.shared_ph_embed(x_sub)
        if spk_emb_main is not None:
            x_main = x_main + spk_emb_main
        if spk_emb_sub is not None:
            x_sub = x_sub + spk_emb_sub
        h = self._SinsyEncoder_0(x_main + x_sub, [lf0_main, lf0_sub], lengths,
                                 train, generator)
        return torch.cat([h, lf0_main, lf0_sub], dim=-1)

    def forward(self, x_main, x_sub, spk_emb_main=None, spk_emb_sub=None,
                lengths=None, y=None, train: bool = False, generator=None):
        h = self.encode(x_main, x_sub, spk_emb_main, spk_emb_sub, lengths,
                        train, generator)
        return ar_decode(self, h, -2, (self.in_lf0_min, self.in_lf0_max),
                         generator, targets=y)

    def inference(self, x_main, x_sub, spk_emb_main=None, spk_emb_sub=None,
                  lengths=None, generator=None):
        return self(x_main, x_sub, spk_emb_main, spk_emb_sub, lengths,
                    generator=generator)[0]
