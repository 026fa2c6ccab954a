"""Generic models on the flagship path: speaker embedding, the Sinsy-style
FFConvLSTM decoder, the (multitrack) variance predictors that serve as
timing models, and the (multitrack) biLSTM encoders.  Counterparts of the
classes of the same names in
``ensemble_svs_with_interactions_tpu/models/generic.py``.

Constructor arguments are the JAX configs' fields; the input widths that
flax infers lazily are derived from them here, and ``init_type`` (and a
speaker table's ``std``) is kept for ``utils/flax_init``.  Every model here also
trains: ``train=True`` applies dropout with masks from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
    ResnetBlock,
    dropout,
    leaky_relu,
    time_mask,
)
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    MDNLayer,
    mdn_get_most_probable_sigma_and_mu,
)

__all__ = [
    "Conv1dResnet",
    "Conv1dResnetMDN",
    "MDN",
    "MDNv2",
    "SpeakerEmbedding",
    "FFConvLSTM",
    "VariancePredictor",
    "MultiTrackVariancePredictor",
    "LSTMEncoder",
    "MultiTrackLSTMEncoder",
]


def _mdn_or_point(model, out):
    """(mu, sigma) of the most probable component for MDN heads."""
    if model.use_mdn:
        sigma, mu = mdn_get_most_probable_sigma_and_mu(*out)
        return mu, sigma
    return out


class SpeakerEmbedding(BaseModel):
    """Speaker-ID embedding table."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, std: float = 0.01):
        super().__init__()
        self.padding_idx, self.std = padding_idx, std
        self.Embed_0 = nn.Embedding(num_embeddings, embedding_dim)
        nn.init.normal_(self.Embed_0.weight, std=std)

    def forward(self, x):
        emb = self.Embed_0(x)
        if self.padding_idx is not None:
            emb = torch.where((x == self.padding_idx)[..., None],
                              torch.zeros_like(emb), emb)
        return emb


class MDN(BaseModel):
    """FFN-MDN: ``num_layers`` x (Dense, ReLU), then an MDN head."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 1, num_gaussians: int = 8,
                 dim_wise: bool = False, init_type: str = "none"):
        super().__init__()
        self.num_layers, self.init_type = num_layers, init_type
        for i in range(num_layers):
            setattr(self, f"Dense_{i}",
                    nn.Linear(in_dim if i == 0 else hidden_dim, hidden_dim))
        self.MDNLayer_0 = MDNLayer(hidden_dim, out_dim, num_gaussians,
                                   dim_wise)

    def prediction_type(self):
        return PredictionType.PROBABILISTIC

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = x
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        return self.MDNLayer_0(h)

    def inference(self, x, lengths=None):
        sigma, mu = mdn_get_most_probable_sigma_and_mu(*self(x, lengths))
        return mu, sigma


class MDNv2(MDN):
    """FFN-MDN with dropout ``dropout`` after each (Dense, ReLU) in
    training: the shipped ``timelag_mdn.yaml`` / ``duration_mdn.yaml``
    timing model."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 1, dropout: float = 0.5,
                 num_gaussians: int = 8, dim_wise: bool = False,
                 init_type: str = "none"):
        super().__init__(in_dim, hidden_dim, out_dim, num_layers,
                         num_gaussians, dim_wise, init_type)
        self.dropout = dropout

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = x
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
            if train:
                h = dropout(h, self.dropout, generator)
        return self.MDNLayer_0(h)


class _Conv1dResnetBody(nn.Module):
    """The MelGAN-style body of ``Conv1dResnet`` and ``ResF0Conv1dResnet``:
    a weight-normed reflection-padded k7 conv (``ReflectConv1d_0``),
    ``num_layers`` ``ResnetBlock``s at dilations 1, 2, 4, ..., a leaky
    ReLU and a weight-normed k7 conv (``ReflectConv1d_1``) to
    ``last_dim``.  The two k7 kernels take ``init_type`` (the residual-F0
    model passes its own, ``Conv1dResnet`` none)."""

    def _add_body(self, in_dim: int, hidden_dim: int, last_dim: int,
                  num_layers: int, init_type: str = "none"):
        self.num_layers = num_layers
        self.ReflectConv1d_0 = ReflectConv1d(in_dim, hidden_dim, 7, init_type,
                                             weight_norm=True)
        for n in range(num_layers):
            setattr(self, f"ResnetBlock_{n}",
                    ResnetBlock(hidden_dim, dilation=2 ** n))
        self.ReflectConv1d_1 = ReflectConv1d(hidden_dim, last_dim, 7,
                                             init_type, weight_norm=True)

    def _body(self, x):
        h = self.ReflectConv1d_0(x)
        for n in range(self.num_layers):
            h = getattr(self, f"ResnetBlock_{n}")(h)
        return self.ReflectConv1d_1(leaky_relu(h))


class Conv1dResnet(BaseModel, _Conv1dResnetBody):
    """MelGAN-inspired conv resnet with an optional MDN head
    (``MDNLayer_0``) and phoneme embedding.  ``forward`` gives (B, T,
    out_dim), or ``(log_pi, log_sigma, mu)`` with ``use_mdn``;
    ``inference`` the output, or ``(mu, sigma)`` of the most probable
    component.  No dropout, no batch norm: training changes nothing in its
    forward.  ``init_type`` is accepted and unused, as in the JAX model."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 4, init_type: str = "none",
                 use_mdn: bool = False, num_gaussians: int = 8,
                 dim_wise: bool = False, in_ph_start_idx: int = 1,
                 in_ph_end_idx: int = 50, embed_dim: Optional[int] = None):
        super().__init__()
        self.use_mdn = use_mdn
        width = in_dim
        self.PhonemeContextEmbedding_0 = None
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        self._add_body(width, hidden_dim,
                       hidden_dim if use_mdn else out_dim, num_layers)
        self.MDNLayer_0 = (MDNLayer(hidden_dim, out_dim, num_gaussians,
                                    dim_wise) if use_mdn else None)

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        h = self._body(x)
        return self.MDNLayer_0(h) if self.use_mdn else h

    def inference(self, x, lengths=None):
        return _mdn_or_point(self, self(x, lengths))


class Conv1dResnetMDN(Conv1dResnet):
    """``Conv1dResnet`` with its MDN head on (kept for config
    compatibility, as in the JAX package)."""

    def __init__(self, *args, use_mdn: bool = True, **kwargs):
        super().__init__(*args, use_mdn=True, **kwargs)


class _ConvBNReLUStack(nn.Module):
    """Conv1d(k=7) + masked BatchNorm + ReLU, ``num_layers`` times."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"ReflectConv1d_{i}",
                    ReflectConv1d(in_dim if i == 0 else hidden_dim,
                                  hidden_dim, kernel_size=7))
            setattr(self, f"MaskedBatchNorm_{i}", MaskedBatchNorm(hidden_dim))

    def forward(self, x, mask=None, train: bool = False):
        for i in range(self.num_layers):
            x = getattr(self, f"ReflectConv1d_{i}")(x)
            x = torch.relu(getattr(self, f"MaskedBatchNorm_{i}")(
                x, mask=mask, train=train))
        return x


class FFConvLSTM(BaseModel):
    """FFN -> Conv(+BN) -> biLSTM -> linear (or MDN) head."""

    def __init__(self, in_dim: int, ff_hidden_dim: int = 2048,
                 conv_hidden_dim: int = 1024, lstm_hidden_dim: int = 256,
                 out_dim: int = 67, dropout: float = 0.0,
                 num_lstm_layers: int = 2, bidirectional: bool = True,
                 init_type: str = "none", use_mdn: bool = False,
                 dim_wise: bool = True, num_gaussians: int = 4,
                 in_ph_start_idx: int = 1, in_ph_end_idx: int = 50,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.use_mdn, self.init_type = use_mdn, init_type
        width = in_dim
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        else:
            self.PhonemeContextEmbedding_0 = None
        for i in range(3):
            setattr(self, f"Dense_{i}",
                    nn.Linear(width if i == 0 else ff_hidden_dim,
                              ff_hidden_dim))
        self._ConvBNReLUStack_0 = _ConvBNReLUStack(ff_hidden_dim,
                                                   conv_hidden_dim)
        self.LSTM_0 = LSTM(conv_hidden_dim, lstm_hidden_dim,
                           num_layers=num_lstm_layers,
                           bidirectional=bidirectional, dropout=dropout)
        if use_mdn:
            self.MDNLayer_0 = MDNLayer(self.LSTM_0.out_dim, out_dim,
                                       num_gaussians, dim_wise)
        else:
            self.Dense_3 = nn.Linear(self.LSTM_0.out_dim, out_dim)

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def forward(self, x, lengths=None, spk_embs=None, train: bool = False,
                generator=None):
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        if spk_embs is not None:
            x = x + spk_embs
        h = x
        for i in range(3):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        h = self._ConvBNReLUStack_0(
            h, time_mask(lengths, h.shape[1], h.device), train)
        h = self.LSTM_0(h, lengths, train, generator)
        if self.use_mdn:
            return self.MDNLayer_0(h)
        return self.Dense_3(h)

    def inference(self, x, lengths=None, spk_embs=None):
        return _mdn_or_point(self, self(x, lengths, spk_embs=spk_embs))


def _add_conv_ln_stack(model, in_dim, out_dim, num_layers, hidden_dim,
                       kernel_size, use_mdn, num_gaussians, dim_wise,
                       dropout_p):
    """Register the variance predictors' body on ``model`` under the flax
    names: ``num_layers`` x (Conv_i (SAME), ReLU, LayerNorm_i with eps
    1e-12 as the reference's custom LayerNorm, dropout ``dropout_p`` in
    training), then a linear (Dense_0) or MDN (MDNLayer_0) head."""
    model.num_layers = num_layers
    model.dropout = dropout_p
    for i in range(num_layers):
        setattr(model, f"Conv_{i}",
                nn.Conv1d(in_dim if i == 0 else hidden_dim, hidden_dim,
                          kernel_size, padding="same"))
        setattr(model, f"LayerNorm_{i}", nn.LayerNorm(hidden_dim, eps=1e-12))
    if use_mdn:
        model.MDNLayer_0 = MDNLayer(hidden_dim, out_dim, num_gaussians,
                                    dim_wise)
    else:
        model.Dense_0 = nn.Linear(hidden_dim, out_dim)


def _conv_ln_stack(model, h, train: bool, generator):
    for i in range(model.num_layers):
        conv = getattr(model, f"Conv_{i}")
        h = torch.relu(conv(h.transpose(1, 2)).transpose(1, 2))
        h = getattr(model, f"LayerNorm_{i}")(h)
        if train:
            h = dropout(h, model.dropout, generator)
    if model.use_mdn:
        return model.MDNLayer_0(h)
    return model.Dense_0(h)


def _mask_features(x, mask_indices):
    if not mask_indices:
        return x
    keep = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    keep[list(mask_indices)] = 0.0
    return x * keep


class VariancePredictor(BaseModel):
    """FastSpeech-style Conv+ReLU+LayerNorm stack (+MDN)."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 5,
                 hidden_dim: int = 256, kernel_size: int = 5,
                 dropout: float = 0.5, init_type: str = "none",
                 use_mdn: bool = False, num_gaussians: int = 1,
                 dim_wise: bool = False, in_ph_start_idx: int = 1,
                 in_ph_end_idx: int = 50, embed_dim: Optional[int] = None,
                 mask_indices: Optional[Sequence[int]] = None):
        super().__init__()
        self.use_mdn, self.init_type = use_mdn, init_type
        self.mask_indices = mask_indices
        width = in_dim
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        else:
            self.PhonemeContextEmbedding_0 = None
        _add_conv_ln_stack(self, width, out_dim, num_layers, hidden_dim,
                           kernel_size, use_mdn, num_gaussians, dim_wise,
                           dropout)

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def forward(self, x, lengths=None, train: bool = False, generator=None):
        x = _mask_features(x, self.mask_indices)
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        return _conv_ln_stack(self, x, train, generator)

    def inference(self, x, lengths=None):
        return _mdn_or_point(self, self(x, lengths))


class MultiTrackVariancePredictor(BaseModel):
    """VariancePredictor over ``concat([x_main, x_sub])`` (each track
    note-merged on the host, so the input is 2 * ``in_dim`` wide) plus
    both tracks' speaker embeddings: the multitrack timelag/duration
    model."""

    def __init__(self, in_dim: int, out_dim: int, num_speaker: int,
                 spk_embed_dim: int, num_layers: int = 5,
                 hidden_dim: int = 256, kernel_size: int = 5,
                 dropout: float = 0.5, init_type: str = "none",
                 use_mdn: bool = False, num_gaussians: int = 1,
                 dim_wise: bool = False, in_ph_start_idx: int = 1,
                 in_ph_end_idx: int = 50, embed_dim: Optional[int] = None,
                 mask_indices: Optional[Sequence[int]] = None):
        super().__init__()
        self.use_mdn, self.init_type = use_mdn, init_type
        self.mask_indices = mask_indices
        width = 2 * in_dim
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                width, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        else:
            self.PhonemeContextEmbedding_0 = None
        self.Embed_0 = nn.Embedding(num_speaker, spk_embed_dim)
        _add_conv_ln_stack(self, width + 2 * spk_embed_dim, out_dim,
                           num_layers, hidden_dim, kernel_size, use_mdn,
                           num_gaussians, dim_wise, dropout)

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def forward(self, x, spks, lengths=None, train: bool = False,
                generator=None):
        x = _mask_features(x, self.mask_indices)
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        e0, e1 = self.Embed_0(spks[0]), self.Embed_0(spks[1])
        if e0.ndim == 2:
            e0, e1 = e0[:, None, :], e1[:, None, :]
        B, T = x.shape[0], x.shape[1]
        e0 = e0.expand(B, T, e0.shape[-1])
        e1 = e1.expand(B, T, e1.shape[-1])
        return _conv_ln_stack(self, torch.cat([x, e0, e1], dim=-1), train,
                              generator)

    def inference(self, x, spks, lengths=None):
        return _mdn_or_point(self, self(x, spks, lengths))


class LSTMEncoder(BaseModel):
    """biLSTM encoder with an optional phoneme embedding and speaker
    embeddings added, then a linear out."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 1, bidirectional: bool = True,
                 dropout: float = 0.0, init_type: str = "none",
                 in_ph_start_idx: int = 1, in_ph_end_idx: int = 50,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.init_type = init_type
        width = in_dim
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        else:
            self.PhonemeContextEmbedding_0 = None
        self.LSTM_0 = LSTM(width, hidden_dim, num_layers=num_layers,
                           bidirectional=bidirectional, dropout=dropout)
        self.Dense_0 = nn.Linear(self.LSTM_0.out_dim, out_dim)

    def forward(self, x, lengths=None, y=None, spk_embs=None,
                train: bool = False, generator=None):
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        if spk_embs is not None:
            x = x + spk_embs
        return self.Dense_0(self.LSTM_0(x, lengths, train, generator))


class MultiTrackLSTMEncoder(BaseModel):
    """Shared phoneme embedding for main and sub track, per-track speaker
    embeddings added, tracks concatenated, then biLSTM and a linear out."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 1, bidirectional: bool = True,
                 dropout: float = 0.0, init_type: str = "none",
                 in_ph_start_idx: int = 1, in_ph_end_idx: int = 50,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.init_type = init_type
        width = in_dim
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        else:
            self.PhonemeContextEmbedding_0 = None
        self.LSTM_0 = LSTM(2 * width, hidden_dim, num_layers=num_layers,
                           bidirectional=bidirectional, dropout=dropout)
        self.Dense_0 = nn.Linear(self.LSTM_0.out_dim, out_dim)

    def forward(self, x_main, x_sub, spk_embs, lengths=None,
                train: bool = False, generator=None):
        if self.PhonemeContextEmbedding_0 is not None:
            x_main = self.PhonemeContextEmbedding_0(x_main)
            x_sub = self.PhonemeContextEmbedding_0(x_sub)
        x = torch.cat([x_main + spk_embs[0], x_sub + spk_embs[1]], dim=-1)
        return self.Dense_0(self.LSTM_0(x, lengths, train, generator))
