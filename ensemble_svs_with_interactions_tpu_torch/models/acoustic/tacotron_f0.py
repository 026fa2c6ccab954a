"""The AR Tacotron decoders of the acoustic zoo: the residual-F0
decoder ``ResF0NonAttentiveDecoder`` (``MDNResF0NonAttentiveDecoder``),
the single-track ``BiLSTMResF0NonAttentiveDecoder``, the interaction F0
model ``MultiTrackBiLSTMResF0NonAttentiveDecoder``, their
``_SinsyEncoder``, and the plain AR stream decoder
``BiLSTMNonAttentiveDecoder`` (``BiLSTMMDNNonAttentiveDecoder``) with its
Post-Net (counterparts in
``ensemble_svs_with_interactions_tpu/models/acoustic/tacotron_f0.py``).

An FF -> Conv(+BN) -> biLSTM encoder sees the score-lf0 track(s), and the
AR residual-F0 decoder predicts lf0 around the (main track's) score.  In
the multitrack model both tracks go through a shared phoneme embedding,
get their speaker embeddings added and are summed first.  Every option of
the JAX decoders is ported (``models/tacotron.py``): the pre-net, zoneout,
the prenet noise, the MDN heads, r = 1 and both downsamplings,
``scaled_tanh`` and ``eval_dropout`` either way.  Teacher-forced, the
decoder's cells run as one recurrence on the kernels at ``zoneout: 0``
and step in PyTorch otherwise.
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
    add_ar_decoder,
    ar_decode,
    decode_and_refine,
)


class _SinsyEncoder(nn.Module):
    """FF x3 -> concat(lf0 scores) -> (Conv k7 + BN + ReLU) x3 -> biLSTM."""

    def __init__(self, in_dim: int, ff_hidden_dim: int, conv_hidden_dim: int,
                 lstm_hidden_dim: int, num_lstm_layers: int, dropout: float,
                 num_lf0_scores: int, init_type: str = "none"):
        super().__init__()
        self.init_type = init_type
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


class _ResF0Decoder(BaseModel):
    """What the residual-F0 AR decoders share: the decoder's set-up
    (:meth:`_add_decoder`), the decode around the score log-F0
    (:meth:`_decode`) and the predicates."""

    def _add_decoder(self, enc_dim: int, out_dim: int, layers: int,
                     hidden_dim: int, reduction_factor: int,
                     downsample_by_conv: bool, in_lf0_idx: int,
                     in_lf0_min: float, in_lf0_max: float,
                     out_lf0_mean: float, out_lf0_scale: float,
                     use_mdn: bool, **core):
        """The AR residual-F0 decoder over ``enc_dim``-wide encoder
        outputs (:func:`add_ar_decoder`; ``core`` holds the
        ``_ARDecoderCore`` options)."""
        self.use_mdn = use_mdn
        self.in_lf0_idx = in_lf0_idx
        self.in_lf0_min, self.in_lf0_max = in_lf0_min, in_lf0_max
        add_ar_decoder(self, enc_dim, out_dim, layers, hidden_dim,
                       reduction_factor, downsample_by_conv,
                       residual_f0=True, use_mdn=use_mdn,
                       out_lf0_mean=float(out_lf0_mean),
                       out_lf0_scale=float(out_lf0_scale), **core)

    def _decode(self, h, lf0_idx: int, y, train: bool, generator):
        """``ar_decode`` of h with the score log-F0 at ``lf0_idx``."""
        return ar_decode(self, h, lf0_idx, (self.in_lf0_min, self.in_lf0_max),
                         generator, targets=y, train=train)

    def is_autoregressive(self) -> bool:
        return True

    def has_residual_lf0_prediction(self) -> bool:
        return True

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)


class ResF0NonAttentiveDecoder(_ResF0Decoder):
    """The AR residual-F0 decoder over encoder outputs (B, T, ``in_dim``):
    the reduced-rate downsampling (the depthwise stride-r
    ``conv_downsample`` with ``downsample_by_conv`` and r > 1, else every
    r-th frame) and the AR decoder core, whose ``out_lf0_idx`` column is
    the score log-F0 at ``in_lf0_idx`` of the encoder outputs plus a
    residual (bounded by a scaled tanh when ``scaled_tanh``).  Every
    option of the JAX decoder is ported: the pre-net (dropout on at
    evaluation with ``eval_dropout``), zoneout (its cells step in PyTorch
    when teacher-forced; at zoneout 0 they run as one recurrence on the
    kernels), the prenet-less dropout, and with ``use_mdn`` the dim-wise
    MDN head (PROBABILISTIC).  Without targets ``y`` it decodes
    free-running; with them it is teacher-forced.  The forward gives
    ``(outs, lf0 residual)``."""

    def __init__(self, in_dim: int = 512, out_dim: int = 1, layers: int = 2,
                 hidden_dim: int = 1024, prenet_layers: int = 2,
                 prenet_hidden_dim: int = 256, prenet_dropout: float = 0.5,
                 zoneout: float = 0.1, reduction_factor: int = 1,
                 downsample_by_conv: bool = False, scaled_tanh: bool = True,
                 in_lf0_idx: int = 300, in_lf0_min: float = 5.3936276,
                 in_lf0_max: float = 6.491111, out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 init_type: str = "none", use_mdn: bool = False,
                 num_gaussians: int = 8, sampling_mode: str = "mean",
                 eval_dropout: bool = True):
        super().__init__()
        self._add_decoder(
            in_dim, out_dim, layers, hidden_dim, reduction_factor,
            downsample_by_conv, in_lf0_idx, in_lf0_min, in_lf0_max,
            out_lf0_mean, out_lf0_scale, use_mdn,
            prenet_layers=prenet_layers, prenet_hidden_dim=prenet_hidden_dim,
            prenet_dropout=prenet_dropout, zoneout=zoneout,
            num_gaussians=num_gaussians, sampling_mode=sampling_mode,
            eval_dropout=eval_dropout, scaled_tanh=scaled_tanh,
            out_lf0_idx=out_lf0_idx)

    def forward(self, encoder_outs, lengths=None, y=None, train: bool = False,
                generator=None):
        return self._decode(encoder_outs, self.in_lf0_idx, y, train,
                            generator)

    def inference(self, x, lengths=None, generator=None):
        return self(x, lengths, generator=generator)[0]


class MDNResF0NonAttentiveDecoder(ResF0NonAttentiveDecoder):
    """:class:`ResF0NonAttentiveDecoder` with the MDN head on by
    default."""

    def __init__(self, *args, use_mdn: bool = True, **kwargs):
        super().__init__(*args, use_mdn=use_mdn, **kwargs)


class _BiLSTMResF0NonAttentiveDecoder(_ResF0Decoder):
    """The body both Sinsy residual-F0 decoders share: an optional phoneme
    embedding (flax scope ``EMBED``), the Sinsy encoder over
    ``NUM_LF0_SCORES`` score-lf0 tracks, then the AR residual-F0 decode
    of :class:`ResF0NonAttentiveDecoder` over the encoder's output and the
    score lf0 (every option ported; the teacher-forced cells run on the
    kernels exactly when ``zoneout`` is 0).  Without targets ``y`` it
    decodes free-running; with them it is teacher-forced.  The prenet-less
    dropout on the fed-back frame applies in both, the pre-net's in
    training or with ``eval_dropout``, the encoder's dropout and zoneout's
    masks only with ``train=True``."""

    EMBED = "PhonemeContextEmbedding_0"
    NUM_LF0_SCORES = 1

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
                 init_type: str = "none", eval_dropout: bool = True):
        super().__init__()
        width = in_dim
        if embed_dim is not None:
            setattr(self, self.EMBED, PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx))
            width = embed_dim
        else:
            setattr(self, self.EMBED, None)
        self._SinsyEncoder_0 = _SinsyEncoder(
            width, ff_hidden_dim, conv_hidden_dim, lstm_hidden_dim,
            num_lstm_layers, dropout, num_lf0_scores=self.NUM_LF0_SCORES,
            init_type=init_type)
        self._add_decoder(
            self._SinsyEncoder_0.LSTM_0.out_dim + self.NUM_LF0_SCORES,
            out_dim, decoder_layers, decoder_hidden_dim, reduction_factor,
            downsample_by_conv, in_lf0_idx, in_lf0_min, in_lf0_max,
            out_lf0_mean, out_lf0_scale, use_mdn,
            prenet_layers=prenet_layers, prenet_hidden_dim=prenet_hidden_dim,
            prenet_dropout=prenet_dropout, zoneout=zoneout,
            num_gaussians=num_gaussians, sampling_mode=sampling_mode,
            eval_dropout=eval_dropout, scaled_tanh=scaled_tanh,
            out_lf0_idx=out_lf0_idx)

    def _embed(self, x):
        embed = getattr(self, self.EMBED)
        return x if embed is None else embed(x)


class BiLSTMResF0NonAttentiveDecoder(_BiLSTMResF0NonAttentiveDecoder):
    """The single-track F0 model: the Sinsy encoder over the score lf0,
    then the AR residual-F0 decoder (decoder ``in_lf0_idx = -1``: the
    score lf0)."""

    def __init__(self, in_dim: int = 512, out_dim: int = 80,
                 out_lf0_idx: int = 180, **kwargs):
        super().__init__(in_dim=in_dim, out_dim=out_dim,
                         out_lf0_idx=out_lf0_idx, **kwargs)

    def encode(self, x, lengths=None, spk_embs=None, train: bool = False,
               generator=None):
        """The non-autoregressive front: (B, T, 2 * lstm_hidden + 1)
        encoder features ending in the score lf0."""
        lf0 = x[:, :, self.in_lf0_idx][..., None]
        x = self._embed(x)
        if spk_embs is not None:
            x = x + spk_embs
        h = self._SinsyEncoder_0(x, [lf0], lengths, train, generator)
        return torch.cat([h, lf0], dim=-1)

    def forward(self, x, lengths=None, y=None, spk_embs=None,
                train: bool = False, generator=None):
        return self._decode(
            self.encode(x, lengths, spk_embs, train, generator),
            -self.NUM_LF0_SCORES, y, train, generator)

    def inference(self, x, lengths=None, spk_embs=None, generator=None):
        return self(x, lengths, spk_embs=spk_embs, generator=generator)[0]


class MultiTrackBiLSTMResF0NonAttentiveDecoder(
        _BiLSTMResF0NonAttentiveDecoder):
    """The interaction F0 model (decoder ``in_lf0_idx = -2``: the main
    track's score lf0).  ``num_speaker`` is accepted and unused, as in the
    JAX package."""

    EMBED = "shared_ph_embed"
    NUM_LF0_SCORES = 2

    def __init__(self, num_speaker: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)

    def encode(self, x_main, x_sub, spk_emb_main=None, spk_emb_sub=None,
               lengths=None, train: bool = False, generator=None):
        """The non-autoregressive front: (B, T, 2 * lstm_hidden + 2)
        encoder features ending in the main and sub score lf0."""
        lf0_main = x_main[:, :, self.in_lf0_idx][..., None]
        lf0_sub = x_sub[:, :, self.in_lf0_idx][..., None]
        x_main, x_sub = self._embed(x_main), self._embed(x_sub)
        if spk_emb_main is not None:
            x_main = x_main + spk_emb_main
        if spk_emb_sub is not None:
            x_sub = x_sub + spk_emb_sub
        h = self._SinsyEncoder_0(x_main + x_sub, [lf0_main, lf0_sub], lengths,
                                 train, generator)
        return torch.cat([h, lf0_main, lf0_sub], dim=-1)

    def forward(self, x_main, x_sub, spk_emb_main=None, spk_emb_sub=None,
                lengths=None, y=None, train: bool = False, generator=None):
        return self._decode(
            self.encode(x_main, x_sub, spk_emb_main, spk_emb_sub, lengths,
                        train, generator), -self.NUM_LF0_SCORES, y, train,
            generator)

    def inference(self, x_main, x_sub, spk_emb_main=None, spk_emb_sub=None,
                  lengths=None, generator=None):
        return self(x_main, x_sub, spk_emb_main, spk_emb_sub, lengths,
                    generator=generator)[0]


class BiLSTMNonAttentiveDecoder(BaseModel):
    """Sinsy-like encoder and the plain (non-residual) AR decoder: an
    optional phoneme embedding, the ``_SinsyEncoder`` with no score-lf0
    input, the AR decode from the go frame ``initial_value`` and, with
    ``postnet_layers > 0`` and no MDN head, the residual Post-Net, whose
    ``[coarse, fine]`` the forward returns and whose fine output
    ``inference`` returns.  Without targets ``y`` it decodes free-running;
    with them it is teacher-forced.  Every option of the JAX decoder is
    ported (the pre-net, zoneout, the prenet noise, the dim-wise MDN head
    with ``use_mdn``, which makes it PROBABILISTIC); the teacher-forced
    cells run on the kernels exactly when ``zoneout`` is 0."""

    def __init__(self, in_dim: int = 512, ff_hidden_dim: int = 2048,
                 conv_hidden_dim: int = 1024, lstm_hidden_dim: int = 256,
                 num_lstm_layers: int = 2, dropout: float = 0.0,
                 out_dim: int = 80, decoder_layers: int = 2,
                 decoder_hidden_dim: int = 1024, prenet_layers: int = 2,
                 prenet_hidden_dim: int = 256, prenet_dropout: float = 0.5,
                 zoneout: float = 0.1, reduction_factor: int = 1,
                 downsample_by_conv: bool = False, use_mdn: bool = False,
                 num_gaussians: int = 4, sampling_mode: str = "mean",
                 in_ph_start_idx: int = 1, in_ph_end_idx: int = 50,
                 embed_dim: Optional[int] = None, init_type: str = "none",
                 initial_value: float = 0.0, prenet_noise_std: float = 0.0,
                 eval_dropout: bool = True, postnet_layers: int = 0,
                 postnet_channels: int = 512, postnet_kernel_size: int = 5,
                 postnet_dropout: float = 0.0):
        super().__init__()
        self.use_mdn = use_mdn
        width = in_dim
        self.PhonemeContextEmbedding_0 = None
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        self._SinsyEncoder_0 = _SinsyEncoder(
            width, ff_hidden_dim, conv_hidden_dim, lstm_hidden_dim,
            num_lstm_layers, dropout, num_lf0_scores=0, init_type=init_type)
        add_ar_decoder(
            self, self._SinsyEncoder_0.LSTM_0.out_dim, out_dim,
            decoder_layers, decoder_hidden_dim, reduction_factor,
            downsample_by_conv, postnet_layers, postnet_channels,
            postnet_kernel_size, postnet_dropout,
            prenet_layers=prenet_layers, prenet_hidden_dim=prenet_hidden_dim,
            prenet_dropout=prenet_dropout, zoneout=zoneout, use_mdn=use_mdn,
            num_gaussians=num_gaussians, sampling_mode=sampling_mode,
            prenet_noise_std=prenet_noise_std, eval_dropout=eval_dropout,
            initial_value=float(initial_value))

    def is_autoregressive(self) -> bool:
        return True

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def forward(self, x, lengths=None, y=None, spk_embs=None,
                train: bool = False, generator=None):
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        if spk_embs is not None:
            x = x + spk_embs
        h = self._SinsyEncoder_0(x, [], lengths, train, generator)
        return decode_and_refine(self, h, lengths, y, train, generator)

    def inference(self, x, lengths=None, spk_embs=None, generator=None):
        outs = self(x, lengths, spk_embs=spk_embs, generator=generator)
        return outs[-1] if isinstance(outs, list) else outs


class BiLSTMMDNNonAttentiveDecoder(BiLSTMNonAttentiveDecoder):
    """:class:`BiLSTMNonAttentiveDecoder` with the MDN head on by
    default."""

    def __init__(self, *args, use_mdn: bool = True, **kwargs):
        super().__init__(*args, use_mdn=use_mdn, **kwargs)
