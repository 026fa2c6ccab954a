"""The multistream acoustic models with a separate F0 model: the
single-track ``MultistreamSeparateF0ParametricModel`` and its
multi-speaker ``MultiSpeakerMultistreamSeparateF0ParametricModel``, the
flagship multitrack ``MultiTrackMultistreamSeparateF0ParametricModel``
(and its experimental ``...v3``, the same model) and the mel voices'
``MultistreamSeparateF0MelModel`` and ``MDNMultistreamSeparateF0MelModel``
(counterparts in
``ensemble_svs_with_interactions_tpu/models/acoustic/multistream.py``).

p(MGC, LF0, VUV, BAP | C) = p(LF0|C) p(MGC|LF0,C) p(VUV|LF0,C) p(BAP|LF0,C):
the (cross-track) lf0 model runs first, the encoder output is concatenated
with the rest flag and the predicted lf0, and the per-stream decoders run
on that.  The mel models predict (mel, lf0, vuv) the same way; the
encoder-less one conditions the mel decoder on (x, lf0) and V/UV on (x,
lf0, mel), as the NPSS cascades do.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.npss import (
    _run_stream_decoder,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
    point_estimate,
)
from ensemble_svs_with_interactions_tpu_torch.models.generic import (
    condition_on_speakers,
    speaker_embeddings,
)
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    split_streams,
)


def _concat_streams(streams, out_dim: int):
    out = torch.cat(streams, dim=-1)
    if out.shape[-1] != out_dim:
        raise ValueError(f"streams give {out.shape[-1]} dims, config says "
                         f"{out_dim}")
    return out


class MultistreamSeparateF0ParametricModel(BaseModel):
    """The single-track model.  Sub-models arrive built
    (``utils.config.instantiate`` builds nested ``_target_`` nodes first);
    the lf0 fields (``in_lf0_*``, ``out_lf0_*``) belong to the lf0
    sub-model's own config and are accepted and unused, and so are
    ``vib_model`` and ``vib_flags_model``, as the JAX model's ``setup``
    builds nothing from them (a vibrato stream comes from ``out_dim`` and
    ``stream_sizes``, not from a sub-model)."""

    def __init__(self, in_dim: int, out_dim: int, stream_sizes: Sequence[int],
                 reduction_factor: int, encoder: Any, mgc_model: Any,
                 lf0_model: Any, vuv_model: Any, bap_model: Any,
                 vib_model: Any = None, vib_flags_model: Any = None,
                 in_rest_idx: int = 1, in_lf0_idx: int = 300,
                 in_lf0_min: float = 5.3936276, in_lf0_max: float = 6.491111,
                 out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 lf0_teacher_forcing: bool = True):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.stream_sizes = list(stream_sizes)
        self.in_rest_idx = in_rest_idx
        self.lf0_teacher_forcing = lf0_teacher_forcing
        self.encoder = encoder
        self.lf0_model = lf0_model
        self.mgc_model = mgc_model
        self.vuv_model = vuv_model
        self.bap_model = bap_model

    def prediction_type(self):
        return PredictionType.MULTISTREAM_HYBRID

    def has_residual_lf0_prediction(self):
        return True

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        """(out (B, T, D) = [mgc | lf0 | vuv | bap], lf0 residual).  With
        targets ``y`` the lf0 model is teacher-forced (and, with
        ``lf0_teacher_forcing``, the decoders see the target lf0)."""
        return self._forward(x, lengths, y, None, train, generator)

    def _forward(self, x, lengths, y, spk_embs, train, generator):
        """The cascade; speaker embeddings ``spk_embs`` (B, T, E), where
        given, go to the lf0 model and the encoder."""
        if x.shape[-1] != self.in_dim:
            raise ValueError(f"input has {x.shape[-1]} dims, config says "
                             f"{self.in_dim}")
        kw = {"train": train, "generator": generator}
        spk = {} if spk_embs is None else {"spk_embs": spk_embs}
        y_s = [None] * 4 if y is None else split_streams(y, self.stream_sizes)
        lf0, lf0_residual = self.lf0_model(x, lengths, y_s[1], **spk, **kw)
        if y is None:
            lf0 = point_estimate(lf0)
        enc = x
        if self.encoder is not None:
            enc = self.encoder(x, lengths, **spk, **kw)
            forced = self.lf0_teacher_forcing and y is not None
            enc = torch.cat([enc, x[:, :, self.in_rest_idx][..., None],
                             y_s[1] if forced else lf0], dim=-1)
        streams = [getattr(self, f"{name}_model")(enc, lengths, **kw)
                   for name in ("mgc", "vuv", "bap")]
        return _concat_streams([streams[0], lf0, *streams[1:]],
                               self.out_dim), lf0_residual

    def inference(self, x, lengths=None, generator=None):
        """The point estimate (B, T, D) = [mgc | lf0 | vuv | bap]."""
        return self(x, lengths, generator=generator)[0]


class MultiSpeakerMultistreamSeparateF0ParametricModel(
        MultistreamSeparateF0ParametricModel):
    """The single-track model with a speaker table
    (``speaker_embedding``): the embeddings of ``spks``, broadcast over
    time, condition the lf0 model and the encoder, not the mgc, vuv or
    bap decoders."""

    def __init__(self, *args, speaker_embedding: Any, **kwargs):
        super().__init__(*args, **kwargs)
        self.speaker_embedding = speaker_embedding
        condition_on_speakers(speaker_embedding, self.lf0_model, self.encoder)

    def forward(self, x, spks, lengths=None, y=None, train: bool = False,
                generator=None):
        e = speaker_embeddings(self.speaker_embedding, spks, x.shape[0],
                               x.shape[1])
        return self._forward(x, lengths, y, e, train, generator)

    def inference(self, x, spks, lengths=None, generator=None):
        return self(x, spks, lengths, generator=generator)[0]


class MultiTrackMultistreamSeparateF0ParametricModel(BaseModel):
    """Sub-models arrive built (``utils.config.instantiate`` builds nested
    ``_target_`` nodes first).  The ensemble uses each track once as the
    main track, so it serves :meth:`inference_main`; :meth:`forward` runs
    both tracks, as training does.  The lf0 fields (``in_lf0_*``,
    ``out_lf0_*``) belong to the lf0 sub-model's own config and are
    accepted and unused.

    ``compat_sub_encoder_outs=True`` feeds the MAIN track's encoder output
    to the sub-track decoders, as the reference does (for its
    checkpoints); the default routes the sub track's own.  ``vib_model``
    and ``vib_flags_model`` are accepted and unused, as in the JAX
    model."""

    def __init__(self, in_dim: int, out_dim: int, stream_sizes: Sequence[int],
                 reduction_factor: int, encoder: Any, mgc_model: Any,
                 lf0_model: Any, vuv_model: Any, bap_model: Any,
                 speaker_embedding: Any, vib_model: Any = None,
                 vib_flags_model: Any = None, in_rest_idx: int = 1,
                 in_lf0_idx: int = 300, in_lf0_min: float = 5.3936276,
                 in_lf0_max: float = 6.491111, out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 lf0_teacher_forcing: bool = True,
                 compat_sub_encoder_outs: bool = False):
        super().__init__()
        self.out_dim = out_dim
        self.stream_sizes = list(stream_sizes)
        self.in_rest_idx = in_rest_idx
        self.lf0_teacher_forcing = lf0_teacher_forcing
        self.compat_sub_encoder_outs = compat_sub_encoder_outs
        self.encoder = encoder
        self.lf0_model = lf0_model
        self.mgc_model = mgc_model
        self.vuv_model = vuv_model
        self.bap_model = bap_model
        self.speaker_embedding = speaker_embedding

    def prediction_type(self):
        return PredictionType.MULTISTREAM_HYBRID

    def has_residual_lf0_prediction(self):
        return True

    def forward(self, x_main, x_sub, spks, lengths=None, ys=None,
                train: bool = False, generator=None):
        """Both tracks.  With targets ``ys = (y_main, y_sub)`` the lf0
        model is teacher-forced and the result is ``((out_main,
        lf0_res_main), (out_sub, lf0_res_sub))``; without, ``(out_main,
        out_sub)``.  Each output is (B, T, D) = [mgc | lf0 | vuv | bap].
        Dropout masks come from ``generator``."""
        is_inference = ys is None
        if is_inference:
            y_m = y_s = [None] * 4
        else:
            y_m = split_streams(ys[0], self.stream_sizes)
            y_s = split_streams(ys[1], self.stream_sizes)
        B, T = x_main.shape[0], x_main.shape[1]
        spk_m = speaker_embeddings(self.speaker_embedding, spks[0], B, T)
        spk_s = speaker_embeddings(self.speaker_embedding, spks[1], B, T)
        lf0_m, res_m = self.lf0_model(x_main, x_sub, spk_m, spk_s, lengths,
                                      y_m[1], train, generator)
        lf0_s, res_s = self.lf0_model(x_sub, x_main, spk_s, spk_m, lengths,
                                      y_s[1], train, generator)
        if is_inference:
            lf0_m, lf0_s = point_estimate(lf0_m), point_estimate(lf0_s)
        enc_m = self.encoder(x_main, x_sub, spk_embs=(spk_m, spk_s),
                             lengths=lengths, train=train,
                             generator=generator)
        enc_s = self.encoder(x_sub, x_main, spk_embs=(spk_s, spk_m),
                             lengths=lengths, train=train,
                             generator=generator)
        forced = self.lf0_teacher_forcing and not is_inference
        enc_m = torch.cat([enc_m, x_main[:, :, self.in_rest_idx][..., None],
                           y_m[1] if forced else lf0_m], dim=-1)
        enc_s = torch.cat([enc_s, x_sub[:, :, self.in_rest_idx][..., None],
                           y_s[1] if forced else lf0_s], dim=-1)
        enc_for_sub = enc_m if self.compat_sub_encoder_outs else enc_s
        outs = {}
        for track, enc in (("m", enc_m), ("s", enc_for_sub)):
            for name in ("mgc", "vuv", "bap"):
                outs[name, track] = getattr(self, f"{name}_model")(
                    enc, lengths, train=train, generator=generator)
        out_m = _concat_streams([outs["mgc", "m"], lf0_m, outs["vuv", "m"],
                                 outs["bap", "m"]], self.out_dim)
        out_s = _concat_streams([outs["mgc", "s"], lf0_s, outs["vuv", "s"],
                                 outs["bap", "s"]], self.out_dim)
        if is_inference:
            return out_m, out_s
        return (out_m, res_m), (out_s, res_s)

    def inference_main(self, x_main, x_sub, spks, lengths=None,
                       generator=None):
        """Main-track outputs (B, T, D) = [mgc | lf0 | vuv | bap], with the
        lf0 model and the encoder conditioned on the sub track."""
        B, T = x_main.shape[0], x_main.shape[1]
        spk_m = speaker_embeddings(self.speaker_embedding, spks[0], B, T)
        spk_s = speaker_embeddings(self.speaker_embedding, spks[1], B, T)
        lf0 = point_estimate(self.lf0_model(x_main, x_sub, spk_m, spk_s,
                                            lengths, generator=generator)[0])
        enc = self.encoder(x_main, x_sub, spk_embs=(spk_m, spk_s),
                           lengths=lengths)
        enc = torch.cat([enc, x_main[:, :, self.in_rest_idx][..., None], lf0],
                        dim=-1)
        return _concat_streams([
            self.mgc_model(enc, lengths), lf0,
            self.vuv_model(enc, lengths), self.bap_model(enc, lengths),
        ], self.out_dim)


class MultiTrackMultistreamSeparateF0ParametricModelv3(
        MultiTrackMultistreamSeparateF0ParametricModel):
    """The reference's experimental variant, which behaves as the base
    model: kept for config compatibility, as in the JAX package."""


class _MelF0Base(BaseModel):
    """What the two mel models share: streams (mel, lf0, vuv), sub-models
    built by ``utils.config.instantiate``, the lf0 fields of the lf0
    sub-model's own config (``in_lf0_*``, ``out_lf0_*``) accepted and
    unused.  ``forward`` with targets ``y`` gives ``((mel, lf0, vuv), lf0
    residual)``, each stream as its decoder returns it (a diffusion
    decoder's ``(noise, x_recon)``); without, ``(out, ...)`` with out (B,
    T, 82) the point estimates [mel | lf0 | vuv], which ``inference``
    returns.  ``generator`` draws dropout masks and the diffusion
    training draws, ``chain_generator`` the sampling chains."""

    def __init__(self, in_dim: int, out_dim: int, stream_sizes: Sequence[int],
                 reduction_factor: int, lf0_model: Any, mel_model: Any,
                 vuv_model: Any, in_rest_idx: int = 0, in_lf0_idx: int = 300,
                 in_lf0_min: float = 5.3936276, in_lf0_max: float = 6.491111,
                 out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034):
        super().__init__()
        if len(stream_sizes) != 3:
            raise ValueError(f"the mel models predict 3 streams (mel, lf0, "
                             f"vuv); got {list(stream_sizes)}")
        self.in_dim, self.out_dim = in_dim, out_dim
        self.stream_sizes = list(stream_sizes)
        self.in_rest_idx = in_rest_idx
        self.lf0_model = lf0_model
        self.mel_model = mel_model
        self.vuv_model = vuv_model

    def prediction_type(self):
        return PredictionType.MULTISTREAM_HYBRID

    def has_residual_lf0_prediction(self):
        return True

    def _lf0(self, x, lengths, y_lf0, train, generator, chain_generator):
        out = _run_stream_decoder(self.lf0_model, x, lengths, y_lf0, None,
                                  train, generator, chain_generator)
        if isinstance(out, tuple) and len(out) == 2:
            return out
        return out, None

    def _decode(self, name, x, lengths, y, train, generator,
                chain_generator):
        return _run_stream_decoder(getattr(self, f"{name}_model"), x,
                                   lengths, y, None, train, generator,
                                   chain_generator)

    @torch.no_grad()
    def inference(self, x, lengths=None, generator=None,
                  chain_generator=None):
        """The point estimate (B, T, D) = [mel | lf0 | vuv]."""
        return self(x, lengths, generator=generator,
                    chain_generator=chain_generator)[0]


class MultistreamSeparateF0MelModel(_MelF0Base):
    """The mel cascade with an encoder: the lf0 model on x, then the mel
    and vuv decoders on [encoder(x) | rest flag | lf0], lf0 the target's
    in training with ``lf0_teacher_forcing``."""

    def __init__(self, in_dim: int, out_dim: int, stream_sizes: Sequence[int],
                 reduction_factor: int, encoder: Any, mel_model: Any,
                 lf0_model: Any, vuv_model: Any,
                 lf0_teacher_forcing: bool = True, **kwargs):
        super().__init__(in_dim, out_dim, stream_sizes, reduction_factor,
                         lf0_model, mel_model, vuv_model, **kwargs)
        self.encoder = encoder
        self.lf0_teacher_forcing = lf0_teacher_forcing

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None, chain_generator=None):
        ys = [None] * 3 if y is None else split_streams(y, self.stream_sizes)
        run = (train, generator, chain_generator)
        lf0, lf0_residual = self._lf0(x, lengths, ys[1], *run)
        if y is None:
            lf0 = point_estimate(lf0)
        enc = x
        if self.encoder is not None:
            enc = self.encoder(x, lengths, train=train, generator=generator)
            cond = ys[1] if self.lf0_teacher_forcing and y is not None \
                else lf0
            enc = torch.cat([enc, x[:, :, self.in_rest_idx][..., None],
                             cond], dim=-1)
        mel = self._decode("mel", enc, lengths, ys[0], *run)
        vuv = self._decode("vuv", enc, lengths, ys[2], *run)
        if y is None:
            return _concat_streams([point_estimate(mel), lf0, vuv],
                                   self.out_dim), lf0_residual
        return (mel, lf0, vuv), lf0_residual


class MDNMultistreamSeparateF0MelModel(_MelF0Base):
    """The encoder-less mel cascade: the lf0 model on x, the mel decoder
    on [x | lf0] and V/UV on x with lf0 and mel as
    ``vuv_model_{lf0,mel}_conditioning`` say, in the order (x, lf0, mel);
    in training lf0 and mel are the targets.  Without targets the
    ``forward`` gives ``(out, out)``, as the JAX model."""

    def __init__(self, in_dim: int, out_dim: int, stream_sizes: Sequence[int],
                 reduction_factor: int, lf0_model: Any, mel_model: Any,
                 vuv_model: Any, vuv_model_lf0_conditioning: bool = True,
                 vuv_model_mel_conditioning: bool = True, **kwargs):
        super().__init__(in_dim, out_dim, stream_sizes, reduction_factor,
                         lf0_model, mel_model, vuv_model, **kwargs)
        self.vuv_model_lf0_conditioning = vuv_model_lf0_conditioning
        self.vuv_model_mel_conditioning = vuv_model_mel_conditioning

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None, chain_generator=None):
        if x.shape[-1] != self.in_dim:
            raise ValueError(f"input has {x.shape[-1]} dims, config says "
                             f"{self.in_dim}")
        is_inference = y is None
        ys = [None] * 3 if y is None else split_streams(y, self.stream_sizes)
        run = (train, generator, chain_generator)
        lf0, lf0_residual = self._lf0(x, lengths, ys[1], *run)
        cond_lf0 = point_estimate(lf0) if is_inference else ys[1]
        mel = self._decode("mel", torch.cat([x, cond_lf0], dim=-1), lengths,
                           ys[0], *run)
        vuv_in = [x]
        if self.vuv_model_lf0_conditioning:
            vuv_in.append(cond_lf0)
        if self.vuv_model_mel_conditioning:
            vuv_in.append(point_estimate(mel) if is_inference else ys[0])
        vuv = self._decode("vuv", torch.cat(vuv_in, dim=-1), lengths, ys[2],
                           *run)
        if is_inference:
            out = _concat_streams([point_estimate(mel), point_estimate(lf0),
                                   vuv], self.out_dim)
            return out, out
        return (mel, lf0, vuv), lf0_residual
