"""The multistream acoustic models with a separate F0 model: the
single-track ``MultistreamSeparateF0ParametricModel`` and the flagship
multitrack ``MultiTrackMultistreamSeparateF0ParametricModel`` (counterparts
in ``ensemble_svs_with_interactions_tpu/models/acoustic/multistream.py``).

p(MGC, LF0, VUV, BAP | C) = p(LF0|C) p(MGC|LF0,C) p(VUV|LF0,C) p(BAP|LF0,C):
the (cross-track) lf0 model runs first, the encoder output is concatenated
with the rest flag and the predicted lf0, and the per-stream decoders run
on that.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
    point_estimate,
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
    sub-model's own config and are accepted and unused.  Vibrato streams
    (``vib_model``, ``vib_flags_model``) are not ported and raise."""

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
        if vib_model is not None or vib_flags_model is not None:
            raise NotImplementedError(
                "vibrato streams need ensemble_svs_with_interactions_tpu/ops/"
                "pitch.py gen_sine_vibrato, which the port has not ported")
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
        if x.shape[-1] != self.in_dim:
            raise ValueError(f"input has {x.shape[-1]} dims, config says "
                             f"{self.in_dim}")
        y_s = [None] * 4 if y is None else split_streams(y, self.stream_sizes)
        lf0, lf0_residual = self.lf0_model(x, lengths, y_s[1], train=train,
                                           generator=generator)
        if y is None:
            lf0 = point_estimate(lf0)
        enc = self.encoder(x, lengths, train=train, generator=generator)
        forced = self.lf0_teacher_forcing and y is not None
        enc = torch.cat([enc, x[:, :, self.in_rest_idx][..., None],
                         y_s[1] if forced else lf0], dim=-1)
        streams = [getattr(self, f"{name}_model")(
            enc, lengths, train=train, generator=generator)
            for name in ("mgc", "vuv", "bap")]
        return _concat_streams([streams[0], lf0, *streams[1:]],
                               self.out_dim), lf0_residual

    def inference(self, x, lengths=None, generator=None):
        """The point estimate (B, T, D) = [mgc | lf0 | vuv | bap]."""
        return self(x, lengths, generator=generator)[0]


class MultiTrackMultistreamSeparateF0ParametricModel(BaseModel):
    """Sub-models arrive built (``utils.config.instantiate`` builds nested
    ``_target_`` nodes first).  The ensemble uses each track once as the
    main track, so it serves :meth:`inference_main`; :meth:`forward` runs
    both tracks, as training does.  The lf0 fields (``in_lf0_*``,
    ``out_lf0_*``) belong to the lf0 sub-model's own config and are
    accepted and unused.

    ``compat_sub_encoder_outs=True`` feeds the MAIN track's encoder output
    to the sub-track decoders, as the reference does (for its
    checkpoints); the default routes the sub track's own."""

    def __init__(self, in_dim: int, out_dim: int, stream_sizes: Sequence[int],
                 reduction_factor: int, encoder: Any, mgc_model: Any,
                 lf0_model: Any, vuv_model: Any, bap_model: Any,
                 speaker_embedding: Any, in_rest_idx: int = 1,
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

    def _expand_spk(self, spk, T):
        e = self.speaker_embedding(spk)
        if e.ndim == 2:
            e = e[:, None, :]
        return e.expand(e.shape[0], T, e.shape[-1])

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
        T = x_main.shape[1]
        spk_m = self._expand_spk(spks[0], T)
        spk_s = self._expand_spk(spks[1], T)
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
        T = x_main.shape[1]
        spk_m = self._expand_spk(spks[0], T)
        spk_s = self._expand_spk(spks[1], T)
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
