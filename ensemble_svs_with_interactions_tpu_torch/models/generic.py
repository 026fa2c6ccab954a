"""The generic model zoo: speaker embedding, feed-forward, (bi)LSTM and
MDN regressors, the shallow-AR models with their FIR analysis filters, the
conv resnets, the Sinsy-style FFConvLSTM decoder (and its multi-speaker
wrapper), the (multitrack) variance predictors that serve as timing
models, the (multitrack) biLSTM encoders and the relative-position
transformer encoder.  Counterparts of the classes of the same names in
``ensemble_svs_with_interactions_tpu/models/generic.py``.

Constructor arguments are the JAX configs' fields; the input widths that
flax infers lazily are derived from them here, and ``init_type`` (and a
speaker table's ``std``) is kept for ``utils/flax_init``.  Every model here also
trains: ``train=True`` applies dropout with masks from a
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
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
    TrTimeInvFIRFilter,
    dropout,
    leaky_relu,
    time_mask,
)
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    MDNLayer,
    mdn_get_most_probable_sigma_and_mu,
)
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    split_streams,
)

__all__ = [
    "SpeakerEmbedding",
    "FFN",
    "FeedForwardNet",
    "LSTMRNN",
    "LSTMRNNSAR",
    "MDN",
    "MDNv2",
    "RMDN",
    "Conv1dResnet",
    "Conv1dResnetSAR",
    "Conv1dResnetMDN",
    "FFConvLSTM",
    "MultiSpeakerFFConvLSTM",
    "VariancePredictor",
    "MultiTrackVariancePredictor",
    "LSTMEncoder",
    "MultiTrackLSTMEncoder",
    "TransformerEncoder",
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


def speaker_embeddings(table, spks, B: int, T: int):
    """The speaker embeddings of ``spks`` broadcast to (B, T, E): ids of
    shape (), (B,) or (B, 1) give (E,), (B, E) or (B, 1, E) rows."""
    e = table(spks)
    if e.ndim == 2:
        e = e[:, None, :]
    return torch.broadcast_to(e, (B, T, e.shape[-1]))


def condition_on_speakers(table, *models):
    """Give every submodule of ``models`` that takes speaker embeddings
    through a projection of its own (the FFT encoder's ``spk_fc``, which
    flax creates at its first call with them) that projection from the
    width of ``table``, a ``SpeakerEmbedding`` (none without one)."""
    if table is None:
        return
    dim = table.Embed_0.embedding_dim
    for model in models:
        for m in model.modules() if model is not None else ():
            if hasattr(m, "add_speaker_input"):
                m.add_speaker_input(dim)


def as_module(node, default_cls):
    """A sub-model given as a module, or built from its config node (its
    ``_target_``, else ``default_cls``)."""
    if isinstance(node, nn.Module):
        return node
    if isinstance(node, dict):
        kwargs = {k: v for k, v in node.items() if k != "_target_"}
        if "_target_" in node:
            from ensemble_svs_with_interactions_tpu_torch.utils.config import (  # noqa: E501
                resolve_target,
            )

            return resolve_target(node["_target_"])(**kwargs)
        return default_cls(**kwargs)
    raise TypeError(f"cannot build module from {type(node)}")


class FFN(BaseModel):
    """Feed-forward net: Dense + ReLU, ``num_layers`` x (Dense, ReLU,
    dropout in training), a linear out (``Dense_{num_layers + 1}``),
    optionally through a sigmoid."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2, dropout: float = 0.0,
                 init_type: str = "none", last_sigmoid: bool = False):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        self.init_type, self.last_sigmoid = init_type, last_sigmoid
        for i in range(num_layers + 1):
            setattr(self, f"Dense_{i}",
                    nn.Linear(in_dim if i == 0 else hidden_dim, hidden_dim))
        setattr(self, f"Dense_{num_layers + 1}",
                nn.Linear(hidden_dim, out_dim))

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = torch.relu(self.Dense_0(x))
        for i in range(1, self.num_layers + 1):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
            if train:
                h = dropout(h, self.dropout, generator)
        out = getattr(self, f"Dense_{self.num_layers + 1}")(h)
        return torch.sigmoid(out) if self.last_sigmoid else out


FeedForwardNet = FFN


class LSTMRNN(BaseModel):
    """(bi)LSTM (``LSTM_0``, on the recurrence kernels) and a linear out
    (``Dense_0``)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 1, bidirectional: bool = True,
                 dropout: float = 0.0, init_type: str = "none"):
        super().__init__()
        self.init_type = init_type
        self.LSTM_0 = LSTM(in_dim, hidden_dim, num_layers=num_layers,
                           bidirectional=bidirectional, dropout=dropout)
        self.Dense_0 = nn.Linear(self.LSTM_0.out_dim, out_dim)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        return self.Dense_0(self.LSTM_0(x, lengths, train, generator))


class _ShallowAR:
    """What the shallow-AR models share: one ``TrTimeInvFIRFilter``
    (``filt{i}``, order ``ar_orders[i]``) per output stream.  The trainer
    filters the target with :meth:`preprocess_target` before the forward
    pass; :meth:`inference` runs the forward and inverts the filters."""

    def _add_filters(self, stream_sizes, ar_orders):
        self.stream_sizes = list(stream_sizes)
        self.num_filters = len(self.stream_sizes)
        for i, (s, K) in enumerate(zip(self.stream_sizes, ar_orders)):
            setattr(self, f"filt{i}", TrTimeInvFIRFilter(s, K + 1))

    def _filters(self):
        return [getattr(self, f"filt{i}") for i in range(self.num_filters)]

    def preprocess_target(self, y):
        ys = split_streams(y, self.stream_sizes)
        return torch.cat([f(yi) for f, yi in zip(self._filters(), ys)],
                         dim=-1)

    def inference(self, x, lengths=None):
        outs = split_streams(self(x, lengths), self.stream_sizes)
        return torch.cat([f.inverse(o) for f, o in zip(self._filters(),
                                                        outs)], dim=-1)


class LSTMRNNSAR(_ShallowAR, BaseModel):
    """``LSTMRNN`` (``lstm``, ``proj``) over filtered targets, with shallow
    AR output filters."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 1, bidirectional: bool = True,
                 dropout: float = 0.0,
                 stream_sizes: Sequence[int] = (180, 3, 1, 15),
                 ar_orders: Sequence[int] = (20, 200, 20, 20),
                 init_type: str = "none"):
        super().__init__()
        self.init_type = init_type
        self.lstm = LSTM(in_dim, hidden_dim, num_layers=num_layers,
                         bidirectional=bidirectional, dropout=dropout)
        self.proj = nn.Linear(self.lstm.out_dim, out_dim)
        self._add_filters(stream_sizes, ar_orders)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        return self.proj(self.lstm(x, lengths, train, generator))


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


class RMDN(BaseModel):
    """LSTM-MDN: Dense + ReLU, a (bi)LSTM on the recurrence kernels, an
    MDN head."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 1, bidirectional: bool = True,
                 dropout: float = 0.0, num_gaussians: int = 8,
                 dim_wise: bool = False, init_type: str = "none"):
        super().__init__()
        self.init_type = init_type
        self.Dense_0 = nn.Linear(in_dim, hidden_dim)
        self.LSTM_0 = LSTM(hidden_dim, hidden_dim, num_layers=num_layers,
                           bidirectional=bidirectional, dropout=dropout)
        self.MDNLayer_0 = MDNLayer(self.LSTM_0.out_dim, out_dim,
                                   num_gaussians, dim_wise)

    def prediction_type(self):
        return PredictionType.PROBABILISTIC

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = torch.relu(self.Dense_0(x))
        return self.MDNLayer_0(self.LSTM_0(h, lengths, train, generator))

    def inference(self, x, lengths=None):
        sigma, mu = mdn_get_most_probable_sigma_and_mu(*self(x, lengths))
        return mu, sigma


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


class Conv1dResnetSAR(_ShallowAR, BaseModel):
    """``Conv1dResnet`` (``backbone``) over filtered targets, with shallow
    AR output filters."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 4,
                 stream_sizes: Sequence[int] = (180, 3, 1, 15),
                 ar_orders: Sequence[int] = (20, 200, 20, 20),
                 init_type: str = "none"):
        super().__init__()
        self.init_type = init_type
        self.backbone = Conv1dResnet(in_dim, hidden_dim, out_dim,
                                     num_layers=num_layers)
        self._add_filters(stream_sizes, ar_orders)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        return self.backbone(x, lengths)


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


class MultiSpeakerFFConvLSTM(BaseModel):
    """``FFConvLSTM`` (``backbone``) with its own speaker table
    (``speaker_embedding``, a module or a config node): the embeddings of
    ``spks``, broadcast over time, are added to the backbone's input after
    its phoneme embedding."""

    def __init__(self, in_dim: int, speaker_embedding: Any,
                 ff_hidden_dim: int = 2048, conv_hidden_dim: int = 1024,
                 lstm_hidden_dim: int = 256, out_dim: int = 67,
                 dropout: float = 0.0, num_lstm_layers: int = 2,
                 bidirectional: bool = True, init_type: str = "none",
                 use_mdn: bool = False, dim_wise: bool = True,
                 num_gaussians: int = 4, in_ph_start_idx: int = 1,
                 in_ph_end_idx: int = 50, embed_dim: Optional[int] = None):
        super().__init__()
        self.use_mdn = use_mdn
        self.speaker_embedding = as_module(speaker_embedding,
                                           SpeakerEmbedding)
        self.backbone = FFConvLSTM(
            in_dim, ff_hidden_dim, conv_hidden_dim, lstm_hidden_dim, out_dim,
            dropout, num_lstm_layers, bidirectional, init_type, use_mdn,
            dim_wise, num_gaussians, in_ph_start_idx, in_ph_end_idx,
            embed_dim)

    def prediction_type(self):
        return self.backbone.prediction_type()

    def forward(self, x, spks, lengths=None, y=None, train: bool = False,
                generator=None):
        e = speaker_embeddings(self.speaker_embedding, spks, x.shape[0],
                               x.shape[1])
        return self.backbone(x, lengths, spk_embs=e, train=train,
                             generator=generator)

    def inference(self, x, spks, lengths=None):
        return _mdn_or_point(self, self(x, spks, lengths))


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


def _relative_to_absolute(x):
    """(B, H, L, 2L - 1) relative logits -> (B, H, L, L) absolute scores,
    by the pad-and-reshape skew."""
    B, H, L, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(B, H, L * 2 * L)
    x = F.pad(x, (0, L - 1))
    return x.reshape(B, H, L + 1, 2 * L - 1)[:, :, :L, L - 1:]


def _absolute_to_relative(x):
    """(B, H, L, L) attention weights -> (B, H, L, 2L - 1) relative
    layout."""
    B, H, L, _ = x.shape
    x = F.pad(x, (0, L - 1)).reshape(B, H, L * L + L * (L - 1))
    x = F.pad(x, (L, 0))
    return x.reshape(B, H, L, 2 * L)[:, :, :, 1:]


def _windowed_relative_embeddings(emb, length: int, window: int):
    """The (n, 2w + 1, d) table padded or sliced to (n, 2L - 1, d):
    distances beyond the window read zeros."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start: start + 2 * length - 1]


def _conv1x1(conv, x):
    """A kernel-1 ``nn.Conv1d`` over (B, T, C) as a linear map."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class _RelativeSelfAttention(nn.Module):
    """Multi-head self-attention with 1x1-conv projections (``conv_q``,
    ``conv_k``, ``conv_v``, ``conv_o``) and windowed relative-position key
    and value embeddings shared by the heads (``emb_rel_k``,
    ``emb_rel_v``, (1, 2w + 1, d_k)); masked scores are -1e4."""

    FLAX_LEAVES = ("emb_rel_k", "emb_rel_v")

    def __init__(self, channels: int, num_heads: int, dropout: float,
                 window_size: Optional[int] = 4):
        super().__init__()
        self.channels, self.num_heads = channels, num_heads
        self.dropout, self.window_size = dropout, window_size
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            setattr(self, name, nn.Conv1d(channels, channels, 1))
        dk = channels // num_heads
        self.emb_rel_k = self.emb_rel_v = None
        if window_size is not None:
            shape = (1, 2 * window_size + 1, dk)
            self.emb_rel_k = nn.Parameter(torch.randn(shape) * dk ** -0.5)
            self.emb_rel_v = nn.Parameter(torch.randn(shape) * dk ** -0.5)

    def forward(self, x, attn_mask, train: bool = False, generator=None):
        B, L, _ = x.shape
        H = self.num_heads
        dk = self.channels // H

        def heads(t):
            return t.reshape(B, L, H, dk).transpose(1, 2)

        q = heads(_conv1x1(self.conv_q, x)) / math.sqrt(dk)
        k = heads(_conv1x1(self.conv_k, x))
        v = heads(_conv1x1(self.conv_v, x))
        scores = q @ k.transpose(-1, -2)
        w = self.window_size
        if w is not None:
            rel_k = _windowed_relative_embeddings(self.emb_rel_k, L, w)
            scores = scores + _relative_to_absolute(
                torch.einsum("bhld,nmd->bhlm", q, rel_k))
        scores = torch.where(attn_mask, scores,
                             torch.full((), -1e4, dtype=scores.dtype,
                                        device=scores.device))
        p = torch.softmax(scores, dim=-1)
        if train:
            p = dropout(p, self.dropout, generator)
        out = p @ v
        if w is not None:
            rel_v = _windowed_relative_embeddings(self.emb_rel_v, L, w)
            out = out + torch.einsum("bhlm,nmd->bhld",
                                     _absolute_to_relative(p), rel_v)
        out = out.transpose(1, 2).reshape(B, L, self.channels)
        return _conv1x1(self.conv_o, out)


class _TransformerBlock(nn.Module):
    """Post-LN block: ``norm_1(x + drop(attn(x)))``, then ``norm_2(x +
    drop(ffn(x)))`` with a masked two-conv FFN (``ffn_conv1`` to
    ``attention_dim``, ReLU, ``ffn_conv2`` back; torch's same padding);
    LayerNorm eps 1e-5; the output masked."""

    def __init__(self, hidden_dim: int, attention_dim: int, num_heads: int,
                 kernel_size: int, dropout: float,
                 window_size: Optional[int] = 4):
        super().__init__()
        self.kernel_size, self.dropout = kernel_size, dropout
        self.attn = _RelativeSelfAttention(hidden_dim, num_heads, dropout,
                                           window_size)
        self.norm_1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.ffn_conv1 = nn.Conv1d(hidden_dim, attention_dim, kernel_size)
        self.ffn_conv2 = nn.Conv1d(attention_dim, hidden_dim, kernel_size)
        self.norm_2 = nn.LayerNorm(hidden_dim, eps=1e-5)

    def _conv(self, conv, x):
        k = self.kernel_size
        h = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
        return conv(h).transpose(1, 2)

    def forward(self, x, mask, train: bool = False, generator=None):
        def drop(t):
            return dropout(t, self.dropout, generator) if train else t

        attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
        fmask = mask[:, :, None].to(x.dtype)
        x = self.norm_1(x + drop(self.attn(x, attn_mask, train, generator)))
        y = drop(torch.relu(self._conv(self.ffn_conv1, x * fmask)))
        y = drop(self._conv(self.ffn_conv2, y * fmask) * fmask)
        return self.norm_2(x + y) * fmask


class TransformerEncoder(BaseModel):
    """Transformer encoder with a reduction factor: an optional phoneme
    embedding, every r-th frame (or a depthwise strided conv, ``Conv_0``,
    with ``downsample_by_conv``), ``Dense_0`` to ``hidden_dim``, the entry
    mask, ``num_layers`` ``_TransformerBlock``s with relative attention
    over ``window_size``, and ``Dense_1`` to r frames of ``out_dim``: (B,
    T // r * r, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 attention_dim: int, num_heads: int = 2, num_layers: int = 2,
                 kernel_size: int = 3, dropout: float = 0.1,
                 reduction_factor: int = 1, init_type: str = "none",
                 downsample_by_conv: bool = False, in_ph_start_idx: int = 1,
                 in_ph_end_idx: int = 50, embed_dim: Optional[int] = None,
                 window_size: Optional[int] = 4):
        super().__init__()
        self.out_dim, self.num_layers = out_dim, num_layers
        self.reduction_factor = r = reduction_factor
        self.init_type = init_type
        width = in_dim
        self.PhonemeContextEmbedding_0 = None
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        self.Conv_0 = (nn.Conv1d(width, width, r, stride=r, groups=width)
                       if r > 1 and downsample_by_conv else None)
        self.Dense_0 = nn.Linear(width, hidden_dim)
        for i in range(num_layers):
            setattr(self, f"_TransformerBlock_{i}", _TransformerBlock(
                hidden_dim, attention_dim, num_heads, kernel_size, dropout,
                window_size))
        self.Dense_1 = nn.Linear(hidden_dim, out_dim * r)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        B, T = x.shape[0], x.shape[1]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int64, device=x.device)
        lengths = torch.as_tensor(lengths, device=x.device)
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        r = self.reduction_factor
        if r > 1:
            lengths = lengths // r
            if self.Conv_0 is not None:
                x = self.Conv_0(x.transpose(1, 2)).transpose(1, 2)
            else:
                x = x[:, r - 1:: r]
        h = self.Dense_0(x)
        mask = torch.arange(h.shape[1], device=x.device)[None] \
            < lengths[:, None]
        h = h * mask[:, :, None].to(h.dtype)
        for i in range(self.num_layers):
            h = getattr(self, f"_TransformerBlock_{i}")(h, mask, train,
                                                        generator)
        return self.Dense_1(h).reshape(B, -1, self.out_dim)
