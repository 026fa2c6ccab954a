"""The flagship multitrack acoustic model,
``MultiTrackMultistreamSeparateF0ParametricModel`` (counterpart in
``ensemble_svs_with_interactions_tpu/models/acoustic/multistream.py``),
inference only.

p(MGC, LF0, VUV, BAP | C) = p(LF0|C) p(MGC|LF0,C) p(VUV|LF0,C) p(BAP|LF0,C):
the cross-track lf0 model runs first, the multitrack encoder output is
concatenated with the rest flag and the predicted lf0, and the per-stream
decoders run on that.
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


class MultiTrackMultistreamSeparateF0ParametricModel(BaseModel):
    """Sub-models arrive built (``utils.config.instantiate`` builds nested
    ``_target_`` nodes first).  The ensemble uses each track once as the
    main track, so the port serves :meth:`inference_main` only.  The lf0
    fields (``in_lf0_*``, ``out_lf0_*``) belong to the lf0 sub-model's own
    config, and teacher forcing to training; both are accepted and
    unused."""

    def __init__(self, in_dim: int, out_dim: int, stream_sizes: Sequence[int],
                 reduction_factor: int, encoder: Any, mgc_model: Any,
                 lf0_model: Any, vuv_model: Any, bap_model: Any,
                 speaker_embedding: Any, in_rest_idx: int = 1,
                 in_lf0_idx: int = 300, in_lf0_min: float = 5.3936276,
                 in_lf0_max: float = 6.491111, out_lf0_idx: int = 180,
                 out_lf0_mean: float = 5.953093881972361,
                 out_lf0_scale: float = 0.23435173188961034,
                 lf0_teacher_forcing: bool = True):
        super().__init__()
        self.out_dim = out_dim
        self.in_rest_idx = in_rest_idx
        self.encoder = encoder
        self.lf0_model = lf0_model
        self.mgc_model = mgc_model
        self.vuv_model = vuv_model
        self.bap_model = bap_model
        self.speaker_embedding = speaker_embedding

    def prediction_type(self):
        return PredictionType.MULTISTREAM_HYBRID

    def _expand_spk(self, spk, T):
        e = self.speaker_embedding(spk)
        if e.ndim == 2:
            e = e[:, None, :]
        return e.expand(e.shape[0], T, e.shape[-1])

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
        out = torch.cat([
            self.mgc_model(enc, lengths), lf0,
            self.vuv_model(enc, lengths), self.bap_model(enc, lengths),
        ], dim=-1)
        if out.shape[-1] != self.out_dim:
            raise ValueError(f"streams give {out.shape[-1]} dims, config "
                             f"says {self.out_dim}")
        return out
