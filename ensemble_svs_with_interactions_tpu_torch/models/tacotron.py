"""Duration-informed autoregressive decoder, inference only: the
counterpart of ``_ARDecoderCore`` and ``ar_decode`` in
``ensemble_svs_with_interactions_tpu/models/tacotron.py``.

The decode is a Python loop over the T / r reduced steps.  The parts of
each step that do not depend on the fed-back frame (the encoder's share of
the first cell's input projection and of the output projection) are
computed for all steps in one matmul before the loop.

Stochastic at inference: without a prenet, the fed-back frame passes
through Bernoulli dropout with p = ``prenet_dropout`` (0.5 in the flagship
recipe) at inference too, as in the reference.  The masks come from an
explicit CPU ``torch.Generator``, so the card and the CPU apply the same
masks; they cannot reproduce ``jax.random``'s bits, so parity with the JAX
package is tested with ``prenet_dropout=0``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    lstm_weights_init,
)

_MAX_LF0_RATIO = 600.0 * np.log(2) / 1200.0


class LSTMCell(nn.Module):
    """One LSTM cell with the recurrence kernel's weight layout: w_x (C, 4H),
    w_h (H, 4H), b (4H,), gate order i, f, g, o (flax OptimizedLSTMCell)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.w_x, self.w_h, self.b = lstm_weights_init(in_dim, hidden_dim)

    @staticmethod
    def update(z, c):
        """Gate pre-activations z (B, 4H) and cell c -> (new c, new h)."""
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


def prenet_dropout_scales(shape, p: float, generator, device):
    """Multipliers for the fed-back frames of a prenet-less decoder:
    1 / (1 - p) where a unit is kept (probability 1 - p), 0 where dropped.
    Drawn from a CPU ``generator`` and moved to ``device``, so one seed
    gives the same masks on every device."""
    keep = torch.rand(shape, generator=generator) < (1.0 - p)
    return (keep.to(torch.float32) / (1.0 - p)).to(device)


class _ARDecoderCore(nn.Module):
    """Decoder LSTM cells ``cell{i}`` and the bias-free ``feat_out``
    projection; :meth:`forward` runs the whole inference loop."""

    def __init__(self, enc_dim: int, out_dim: int, layers: int,
                 hidden_dim: int, prenet_dropout: float,
                 reduction_factor: int, out_lf0_idx: int,
                 out_lf0_mean: float, out_lf0_scale: float):
        super().__init__()
        self.out_dim, self.layers = out_dim, layers
        self.hidden_dim, self.r = hidden_dim, reduction_factor
        self.prenet_dropout = prenet_dropout
        self.out_lf0_idx = out_lf0_idx
        self.out_lf0_mean, self.out_lf0_scale = out_lf0_mean, out_lf0_scale
        for i in range(layers):
            setattr(self, f"cell{i}",
                    LSTMCell(enc_dim + out_dim if i == 0 else hidden_dim,
                             hidden_dim))
        self.feat_out = nn.Linear(hidden_dim + enc_dim,
                                  out_dim * reduction_factor, bias=False)

    def forward(self, enc, lf0_den, generator=None):
        """enc (B, T, C) reduced-rate encoder outputs, lf0_den (B, T, r)
        denormalized score log-F0 -> outs (B, T, r, D), res (B, T, r)."""
        B, T, C = enc.shape
        D, r, Hd = self.out_dim, self.r, self.hidden_dim
        cell0 = self.cell0
        xw_enc = torch.matmul(enc, cell0.w_x[:C]) + cell0.b
        w_prev = cell0.w_x[C:]
        w_fh = self.feat_out.weight[:, :Hd].t()
        out_enc = torch.matmul(enc, self.feat_out.weight[:, Hd:].t())
        if self.prenet_dropout > 0:
            if generator is None:
                raise ValueError("prenet dropout at inference needs a "
                                 "torch.Generator")
            scales = prenet_dropout_scales((T, B, D), self.prenet_dropout,
                                           generator, enc.device)
        else:
            scales = None
        cs = [enc.new_zeros(B, Hd) for _ in range(self.layers)]
        hs = [enc.new_zeros(B, Hd) for _ in range(self.layers)]
        prev = enc.new_zeros(B, D)
        outs, ress = [], []
        for t in range(T):
            fed = prev * scales[t] if scales is not None else prev
            inp = None
            for i in range(self.layers):
                cell = getattr(self, f"cell{i}")
                if i == 0:
                    z = xw_enc[:, t] + fed @ w_prev + hs[0] @ cell.w_h
                else:
                    z = inp @ cell.w_x + (hs[i] @ cell.w_h + cell.b)
                cs[i], hs[i] = LSTMCell.update(z, cs[i])
                inp = hs[i]
            out = (inp @ w_fh + out_enc[:, t]).reshape(B, D, r).transpose(1, 2)
            raw = out[..., self.out_lf0_idx]
            res = _MAX_LF0_RATIO * torch.tanh(raw)
            lf0 = (lf0_den[:, t] + res - self.out_lf0_mean) / self.out_lf0_scale
            out = out.clone()
            out[..., self.out_lf0_idx] = lf0
            prev = out[:, -1, :]
            outs.append(out)
            ress.append(res)
        return torch.stack(outs, dim=1), torch.stack(ress, dim=1)


def ar_decode(parent, encoder_outs, in_lf0_idx: int, lf0_params,
              generator=None):
    """Residual-F0 AR inference for a decoder module ``parent`` that owns
    ``conv_downsample`` (the depthwise stride-r conv that takes the
    encoder to the reduced rate) and ``ar_core``.

    encoder_outs (B, T, C) -> (outs (B, T, D), lf0_residual (B, T, 1)).
    """
    r = parent.reduction_factor
    B, T_orig, _ = encoder_outs.shape
    pad = (-T_orig) % r
    if pad:
        encoder_outs = F.pad(encoder_outs, (0, 0, 0, pad))
    in_lf0_min, in_lf0_max = lf0_params
    lf0_score = encoder_outs[:, :, in_lf0_idx]
    lf0_den = (lf0_score * (in_lf0_max - in_lf0_min) + in_lf0_min).reshape(
        B, -1, r)
    enc = parent.conv_downsample(encoder_outs.transpose(1, 2)).transpose(1, 2)
    outs, res = parent.ar_core(enc, lf0_den[:, : enc.shape[1]], generator)
    T = enc.shape[1]
    outs = outs.reshape(B, T * r, -1)[:, :T_orig]
    return outs, res.reshape(B, T * r, 1)[:, :T_orig]
