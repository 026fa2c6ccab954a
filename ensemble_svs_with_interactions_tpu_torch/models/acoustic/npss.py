"""The NPSS cascades (counterparts in
``ensemble_svs_with_interactions_tpu/models/acoustic/npss.py``).

p(MGC, LF0, VUV, BAP | C) = p(LF0|C) p(MGC|LF0,C) p(BAP|LF0,C)
p(VUV|LF0,MGC,BAP,C): the lf0 model runs first, the mgc and bap models
take (x, lf0), and the vuv model takes x with the streams its
``vuv_model_*_conditioning`` flags name, in the order (mgc, lf0, bap) of
the MDN cascades or (mgc, bap, lf0) of the deterministic one.  With
targets the downstream models are teacher-forced on them.

* ``NPSSMultistreamParametricModel``: the deterministic single-track
  cascade; the shipped ``acoustic_npss_ar_mgcf0bap.yaml`` makes mgc and
  bap AR ``BiLSTMNonAttentiveDecoder``s with Post-Nets (``[coarse,
  fine]``) and lf0 the AR residual-F0 decoder;
* ``NPSSMDNMultistreamParametricModel``: the single-track cascade with
  MDN stream models (``acoustic_npss_mdn.yaml``: ``Conv1dResnet`` MDN
  heads, a ``ResF0Conv1dResnet`` lf0 model);
* ``MultiSpeakerNPSSMDNMultistreamParametricModel``: that cascade with a
  speaker table, whose embeddings go to every stream model that takes
  them;
* ``MultiTrackNPSSMDNMultistreamParametricModel``: the multitrack cascade
  with a cross-track lf0 model; the recipe's configuration
  (``multitrack_acoustic_npss_diff_mgcbap.yaml``) makes mgc and bap
  ``GaussianDiffusion`` decoders, which sample at inference from the
  ``chain_generator`` they are given.
"""

from __future__ import annotations

import inspect
from typing import Any, Sequence

import torch

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
    concat_stream_outputs,
    point_estimate,
)
from ensemble_svs_with_interactions_tpu_torch.models.generic import (
    condition_on_speakers,
    speaker_embeddings,
)
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    split_streams,
)


def _takes(mod, arg: str) -> bool:
    return arg in inspect.signature(mod.forward).parameters


def _run_stream_decoder(mod, x, lengths, y, spk_embs, train, generator,
                        chain_generator):
    """A cascade stream decoder: free-running (``y`` None) diffusion
    decoders sample through ``inference``; everything else runs its
    forward, teacher-forced on ``y`` where it takes targets (the output
    MDN heads keep their parameter tuples, the Post-Net decoders their
    ``[coarse, fine]``).  ``spk_embs`` goes only to decoders whose forward
    takes it."""
    kw = {}
    if _takes(mod, "spk_embs"):
        kw["spk_embs"] = spk_embs
    if mod.prediction_type() == PredictionType.DIFFUSION:
        if y is None:
            return mod.inference(x, lengths, chain_generator=chain_generator,
                                 **kw)
        return mod(x, lengths, y, train=train, generator=generator, **kw)
    if _takes(mod, "y"):
        kw["y"] = y
    return mod(x, lengths, train=train, generator=generator, **kw)


class _NPSSBase(BaseModel):
    """The cascade every NPSS model shares.  Sub-models arrive built
    (``utils.config.instantiate`` builds nested ``_target_`` nodes first).
    The lf0 fields (``in_lf0_*``, ``out_lf0_*``, ``reduction_factor``)
    belong to the lf0 sub-model's own config, and they and
    ``in_rest_idx`` are accepted and unused, as in the JAX cascades."""

    # the MDN cascades condition V/UV on (x, mgc, lf0, bap)
    _VUV_COND_ORDER = ("mgc", "lf0", "bap")

    def __init__(self, in_dim: int, out_dim: int,
                 stream_sizes: Sequence[int] = (60, 1, 1, 5),
                 reduction_factor: int = 1, lf0_model: Any = None,
                 mgc_model: Any = None, bap_model: Any = None,
                 vuv_model: Any = None, in_rest_idx: int = 0,
                 in_lf0_idx: int = 51, in_lf0_min: float = 5.3936276,
                 in_lf0_max: float = 6.491111, out_lf0_idx: int = 60,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 vuv_model_bap_conditioning: bool = True,
                 vuv_model_bap0_conditioning: bool = False,
                 vuv_model_lf0_conditioning: bool = True,
                 vuv_model_mgc_conditioning: bool = False):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.stream_sizes = list(stream_sizes)
        self.lf0_model = lf0_model
        self.mgc_model = mgc_model
        self.bap_model = bap_model
        self.vuv_model = vuv_model
        self.vuv_conditioning = {"mgc": vuv_model_mgc_conditioning,
                                 "lf0": vuv_model_lf0_conditioning,
                                 "bap": vuv_model_bap_conditioning}
        self.vuv_model_bap0_conditioning = vuv_model_bap0_conditioning

    def has_residual_lf0_prediction(self):
        return True

    def _vuv_inputs(self, x, mgc, lf0, bap):
        feats = {"mgc": mgc, "lf0": lf0,
                 "bap": bap[..., 0:1] if self.vuv_model_bap0_conditioning
                 else bap}
        return torch.cat([x] + [feats[k] for k in self._VUV_COND_ORDER
                                if self.vuv_conditioning[k]], dim=-1)

    def _targets(self, y):
        return [None] * 4 if y is None else split_streams(y,
                                                          self.stream_sizes)

    def _cascade(self, x, lengths, ys, lf0_out, spk_e, train, generator,
                 chain_generator):
        """(mgc, lf0, vuv, bap, lf0 residual) from the lf0 model's output
        ``lf0_out`` (``(lf0, residual)``, or lf0 alone) and the targets
        ``ys`` (four Nones free-running); mgc runs before bap."""
        is_inference = ys[0] is None
        if isinstance(lf0_out, tuple) and len(lf0_out) == 2:
            lf0, lf0_residual = lf0_out
        else:
            lf0, lf0_residual = lf0_out, None
        cond_lf0 = point_estimate(lf0) if is_inference else ys[1]
        dec_in = torch.cat([x, cond_lf0], dim=-1)
        run = (spk_e, train, generator, chain_generator)
        mgc = _run_stream_decoder(self.mgc_model, dec_in, lengths, ys[0],
                                  *run)
        bap = _run_stream_decoder(self.bap_model, dec_in, lengths, ys[3],
                                  *run)
        if is_inference:
            vuv_in = self._vuv_inputs(x, point_estimate(mgc), cond_lf0,
                                      point_estimate(bap))
        else:
            vuv_in = self._vuv_inputs(x, ys[0], ys[1], ys[3])
        vuv = _run_stream_decoder(self.vuv_model, vuv_in, lengths, ys[2],
                                  *run)
        return mgc, lf0, vuv, bap, lf0_residual

    def _single_track(self, x, lengths, y, train, generator,
                      chain_generator, spk_e=None):
        ys = self._targets(y)
        lf0_out = _run_stream_decoder(self.lf0_model, x, lengths, ys[1],
                                      spk_e, train, generator,
                                      chain_generator)
        return self._cascade(x, lengths, ys, lf0_out, spk_e, train,
                             generator, chain_generator)


class NPSSMultistreamParametricModel(_NPSSBase):
    """The deterministic single-track cascade.  ``forward`` gives ``(out,
    lf0 residual)``: out the streams [mgc | lf0 | vuv | bap] concatenated,
    a ``[coarse, fine]`` list where a stream decoder has a Post-Net;
    ``inference`` the fine (B, T, D).  ``npss_style_conditioning`` must
    stay off, as in the JAX model."""

    # the deterministic cascade conditions V/UV on (x, mgc, bap, lf0)
    _VUV_COND_ORDER = ("mgc", "bap", "lf0")

    def __init__(self, *args, npss_style_conditioning: bool = False,
                 **kwargs):
        if npss_style_conditioning:
            raise NotImplementedError("npss_style_conditioning is not "
                                      "supported (nor in the JAX package)")
        super().__init__(*args, **kwargs)

    def prediction_type(self):
        return PredictionType.DETERMINISTIC

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None, chain_generator=None):
        mgc, lf0, vuv, bap, lf0_residual = self._single_track(
            x, lengths, y, train, generator, chain_generator)
        return (concat_stream_outputs([mgc, lf0, vuv, bap], self.out_dim),
                lf0_residual)

    @torch.no_grad()
    def inference(self, x, lengths=None, generator=None,
                  chain_generator=None):
        out = self(x, lengths, generator=generator,
                   chain_generator=chain_generator)[0]
        return out[-1] if isinstance(out, list) else out


class NPSSMDNMultistreamParametricModel(_NPSSBase):
    """The single-track cascade with MDN stream models
    (MULTISTREAM_HYBRID): with targets ``((mgc, lf0, vuv, bap), lf0
    residual)``, each stream as its model returns it (MDN parameter
    tuples kept); without, ``(out, lf0 residual)`` with out the point
    estimates concatenated, which ``inference`` returns."""

    def prediction_type(self):
        return PredictionType.MULTISTREAM_HYBRID

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None, chain_generator=None):
        return self._mdn_forward(x, lengths, y, train, generator,
                                 chain_generator)

    def _mdn_forward(self, x, lengths, y, train, generator, chain_generator,
                     spk_e=None):
        mgc, lf0, vuv, bap, lf0_residual = self._single_track(
            x, lengths, y, train, generator, chain_generator, spk_e)
        if y is None:
            return torch.cat([point_estimate(mgc), point_estimate(lf0), vuv,
                              point_estimate(bap)], dim=-1), lf0_residual
        return (mgc, lf0, vuv, bap), lf0_residual

    @torch.no_grad()
    def inference(self, x, lengths=None, generator=None,
                  chain_generator=None):
        return self(x, lengths, generator=generator,
                    chain_generator=chain_generator)[0]


class MultiSpeakerNPSSMDNMultistreamParametricModel(
        NPSSMDNMultistreamParametricModel):
    """The MDN cascade with a speaker table (``speaker_embedding``): the
    embeddings of ``spks``, broadcast over time, go to each of the lf0,
    mgc, bap and vuv models whose forward takes ``spk_embs``.  Without
    targets it gives the concatenated point estimates, with them the
    stream tuple."""

    def __init__(self, *args, speaker_embedding: Any = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.speaker_embedding = speaker_embedding
        condition_on_speakers(speaker_embedding, self.lf0_model,
                              self.mgc_model, self.bap_model, self.vuv_model)

    def forward(self, x, spks, lengths=None, y=None, train: bool = False,
                generator=None, chain_generator=None):
        e = speaker_embeddings(self.speaker_embedding, spks, x.shape[0],
                               x.shape[1])
        return self._mdn_forward(x, lengths, y, train, generator,
                                 chain_generator, e)

    @torch.no_grad()
    def inference(self, x, spks, lengths=None, generator=None,
                  chain_generator=None):
        return self(x, spks, lengths, generator=generator,
                    chain_generator=chain_generator)[0]


class MultiTrackNPSSMDNMultistreamParametricModel(_NPSSBase):
    """The full cascade runs for the main track; in training with
    ``output_subtrack`` the sub track gives its cross-conditioned lf0
    prediction, its other streams coming back as the targets."""

    def __init__(self, in_dim: int, out_dim: int,
                 speaker_embedding: Any = None, output_subtrack: bool = True,
                 **kwargs):
        super().__init__(in_dim, out_dim, **kwargs)
        self.speaker_embedding = speaker_embedding
        self.output_subtrack = output_subtrack

    def prediction_type(self):
        return PredictionType.MULTISTREAM_HYBRID

    def _main_cascade(self, x, x_other, spk_e, spk_e_other, lengths, y,
                      train, generator, chain_generator):
        """(mgc, lf0, vuv, bap, lf0 residual) of the main track: the
        stream decoders speaker-conditioned where they take it."""
        ys = self._targets(y)
        lf0_out = self.lf0_model(x, x_other, spk_e, spk_e_other, lengths,
                                 ys[1], train, generator)
        return self._cascade(x, lengths, ys, lf0_out, spk_e, train,
                             generator, chain_generator)

    def forward(self, x_main, x_sub, spks, lengths=None, ys=None,
                train: bool = False, generator=None, chain_generator=None):
        """Without targets ``(out, out)``, (B, T, D) = [mgc | lf0 | vuv |
        bap] of the main track (the sub slot is a copy, as the reference
        returns it).  With ``ys = (y_main, y_sub)``: ``((mgc, lf0, vuv,
        bap), lf0 residual)`` of the main track (diffusion streams as
        ``(noise, x_recon)``) and, with ``output_subtrack``, the sub
        track's ``((y_mgc, lf0, y_vuv, y_bap), lf0 residual)``, else
        ``(None, None)``.  ``generator`` draws dropout masks and the
        diffusion training draws; ``chain_generator`` the sampling
        chains."""
        B, T = x_main.shape[0], x_main.shape[1]
        e_m = speaker_embeddings(self.speaker_embedding, spks[0], B, T)
        e_s = speaker_embeddings(self.speaker_embedding, spks[1], B, T)
        mgc, lf0, vuv, bap, res_m = self._main_cascade(
            x_main, x_sub, e_m, e_s, lengths, None if ys is None else ys[0],
            train, generator, chain_generator)
        if ys is None:
            out = torch.cat([point_estimate(mgc), point_estimate(lf0), vuv,
                             point_estimate(bap)], dim=-1)
            return out, out
        if not self.output_subtrack:
            return ((mgc, lf0, vuv, bap), res_m), (None, None)
        y_mgc_s, y_lf0_s, y_vuv_s, y_bap_s = split_streams(ys[1],
                                                           self.stream_sizes)
        lf0_s, res_s = self.lf0_model(x_sub, x_main, e_s, e_m, lengths,
                                      y_lf0_s, train, generator)
        return ((mgc, lf0, vuv, bap), res_m), (
            (y_mgc_s, lf0_s, y_vuv_s, y_bap_s), res_s)

    @torch.no_grad()
    def inference(self, x_main, x_sub, spks=None, lengths=None,
                  generator=None, chain_generator=None):
        return self(x_main, x_sub, spks, lengths, generator=generator,
                    chain_generator=chain_generator)

    def inference_main(self, x_main, x_sub, spks=None, lengths=None,
                       generator=None, chain_generator=None):
        """The main track's output, ``inference(...)[0]``."""
        return self.inference(x_main, x_sub, spks, lengths, generator,
                              chain_generator)[0]


class V2MultiTrackNPSSMDNMultistreamParametricModel(
        MultiTrackNPSSMDNMultistreamParametricModel):
    """The reference's experimental variant: the same cascade, kept for
    config compatibility (``output_subtrack`` True by default)."""
