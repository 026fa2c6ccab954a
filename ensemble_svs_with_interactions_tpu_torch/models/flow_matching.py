"""Conditional flow-matching (rectified-flow) acoustic decoder, the
counterpart of ``ensemble_svs_with_interactions_tpu/models/flow_matching.py``.

``FlowMatching`` fills the slot of ``GaussianDiffusion``
(``PredictionType.DIFFUSION``, the same ``forward`` / ``inference``
signatures and ``norm_scale``): the ``DiffNet`` it is given regresses the
velocity x1 - x0 of the straight path from noise x0 to the scaled target
x1, and inference integrates that field from t = 0 to 1 in
``sampling_steps`` Euler or midpoint steps.  Its draws (t and x0 in
training, x at t = 0 in inference) come from the generators it is given
or from a ``models/diffsinger.chain_noise`` block, as the diffusion
decoder's do.  The network is plain torch, as the JAX package leaves it
to XLA.

``MultiSpeakerFlowMatching`` conditions the encoder on a speaker table,
as ``models/diffsinger.MultiSpeakerGaussianDiffusion`` does.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.diffsinger import (
    _normal,
    _record,
    _replayed,
    _tensor,
)
from ensemble_svs_with_interactions_tpu_torch.models.generic import (
    condition_on_speakers,
    speaker_embeddings,
)
from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
    conv_precision,
)


class FlowMatching(BaseModel):
    """Rectified flow over (B, T, out_dim) features with an optional
    condition encoder.  ``time_scale`` maps t in [0, 1] onto the
    denoiser's step embedding.  ``allow_tf32`` (an attribute, False by
    default) lets cuDNN take TF32 in the network, as ``GaussianDiffusion``'s
    does."""

    def __init__(self, in_dim: int, out_dim: int, denoise_fn: nn.Module,
                 encoder: Optional[nn.Module] = None,
                 norm_scale: float = 10.0, sampling_steps: int = 8,
                 solver: str = "midpoint", time_scale: float = 1000.0):
        super().__init__()
        if solver not in ("euler", "midpoint"):
            raise ValueError(f"unknown ODE solver: {solver}")
        self.in_dim, self.out_dim = in_dim, out_dim
        self.denoise_fn = denoise_fn
        self.encoder = encoder
        self.norm_scale = norm_scale
        self.sampling_steps = sampling_steps
        self.solver = solver
        self.time_scale = time_scale
        self.allow_tf32 = False

    def prediction_type(self):
        return PredictionType.DIFFUSION

    def _cond(self, cond, lengths, spk_embs, train, generator):
        if self.encoder is None:
            return cond
        kw = {"train": train}
        if train:
            kw["generator"] = generator
        if spk_embs is not None:
            kw["spk_embs"] = spk_embs
        return self.encoder(cond, lengths, **kw)

    def forward(self, cond, lengths=None, y=None, spk_embs=None,
                train: bool = False, generator=None):
        """The training forward: t uniform in [0, 1) (float32) and x0
        standard normal in the target's dtype from ``generator`` (which
        also draws the encoder's dropout), as the JAX model draws them;
        returns ``(x1 - x0, predicted velocity)``, (B, T, out_dim) each,
        the ``DIFFUSION`` pair the losses score."""
        B = cond.shape[0]
        cond = self._cond(cond, lengths, spk_embs, train, generator)
        x1 = y / self.norm_scale
        entry = _replayed()
        if entry is None:
            if generator is None:
                raise ValueError("the flow-matching training forward draws "
                                 "t and x0 from a torch.Generator")
            t = torch.rand((B,), generator=generator,
                           device=generator.device).to(x1.device)
            x0 = _normal(x1.shape, generator, x1.device).to(x1.dtype)
            _record({"t": t, "noise": x0})
        else:
            t = _tensor(entry["t"]).to(x1.device, torch.float32)
            x0 = _tensor(entry["noise"]).to(x1)
        x_t = (1.0 - t)[:, None, None] * x0 + t[:, None, None] * x1
        with conv_precision(x1.device, self.allow_tf32):
            v_pred = self.denoise_fn(x_t, t * self.time_scale, cond)
        return x1 - x0, v_pred

    @torch.no_grad()
    def inference(self, cond, lengths=None, spk_embs=None,
                  chain_generator=None):
        """Integrate from x ~ N(0, I) (drawn from ``chain_generator``, or
        a :func:`chain_noise` block) over ``sampling_steps`` steps of the
        solver; (B, T, out_dim) features.  The step times are float32, as
        the JAX package computes them."""
        B, T = cond.shape[0], cond.shape[1]
        cond = self._cond(cond, lengths, spk_embs, False, None)
        shape = (B, T, self.out_dim)
        entry = _replayed()
        if entry is None:
            x = _normal(shape, chain_generator, cond.device)
            _record({"x_T": x, "steps": None})
        else:
            x = _tensor(entry["x_T"]).to(cond)
        cond = cond.transpose(1, 2).contiguous()
        x = x.transpose(1, 2).contiguous()
        n = max(int(self.sampling_steps), 1)
        dt = 1.0 / n
        f32 = np.float32
        scale = f32(self.time_scale)

        def v(x, t):
            tb = torch.full((B,), float(t * scale), dtype=x.dtype,
                            device=x.device)
            return self.denoise_fn.denoise(x, tb, cond)

        with conv_precision(cond.device, self.allow_tf32):
            for t in np.asarray(np.arange(n) * dt, f32):
                if self.solver == "euler":
                    x = x + dt * v(x, t)
                else:
                    x_mid = x + 0.5 * dt * v(x, t)
                    x = x + dt * v(x_mid, t + f32(0.5 * dt))
        return x.transpose(1, 2) * self.norm_scale



class MultiSpeakerFlowMatching(FlowMatching):
    """``FlowMatching`` with a speaker table (``speaker_embedding``): the
    embeddings of ``spks``, broadcast over time, go to the condition
    encoder; without an encoder they reach nothing, as in the JAX
    model."""

    def __init__(self, *args, speaker_embedding: Any = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.speaker_embedding = speaker_embedding
        condition_on_speakers(speaker_embedding, self.encoder)

    def _spk_embs(self, spks, cond):
        return speaker_embeddings(self.speaker_embedding, spks,
                                  cond.shape[0], cond.shape[1])

    def forward(self, cond, spks, lengths=None, y=None, train: bool = False,
                generator=None):
        return super().forward(cond, lengths, y,
                               spk_embs=self._spk_embs(spks, cond),
                               train=train, generator=generator)

    @torch.no_grad()
    def inference(self, cond, spks, lengths=None, chain_generator=None):
        return super().inference(cond, lengths,
                                 spk_embs=self._spk_embs(spks, cond),
                                 chain_generator=chain_generator)
