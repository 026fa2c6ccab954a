"""Duration-informed autoregressive decoder: the counterpart of
``_ARDecoderCore`` and ``ar_decode`` in
``ensemble_svs_with_interactions_tpu/models/tacotron.py``.

Inference is a Python loop over the T / r reduced steps.  The parts of
each step that do not depend on the fed-back frame (the encoder's share of
the first cell's input projection and of the output projection) are
computed for all steps in one matmul before the loop.

Teacher forcing (training, or evaluation with targets) feeds back the
previous target frame, the go frame 0 at the first step.  Without zoneout
every input of the decoder's LSTM cells is then known before the loop, so
each cell runs as one recurrence over the whole sequence (the hand-written
forward and BPTT kernels on the card) and the output projection and the
residual-F0 head run batched: there is no per-step Python loop.

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
    dropout,
    lstm_sequence,
    lstm_weights_init,
)

_MAX_LF0_RATIO = 600.0 * np.log(2) / 1200.0


def lf0_residual(raw):
    """The residual log-F0 ``_MAX_LF0_RATIO * tanh(raw)``, in float32 at
    least.  The JAX package's ratio is a NumPy float64 scalar, which JAX
    does not take as a weak type: it promotes a bf16 ``tanh`` to float32.
    So under AMP the predicted log-F0, the score's denormalized log-F0
    (about 6, where bf16 steps by 0.03) plus this residual (at most 0.35),
    is summed in float32, and only its normalized value is rounded to the
    output's dtype."""
    t = torch.tanh(raw)
    return _MAX_LF0_RATIO * t.to(torch.promote_types(t.dtype,
                                                     torch.float32))


class LSTMCell(nn.Module):
    """One LSTM cell with the recurrence kernel's weight layout: w_x (C, 4H),
    w_h (H, 4H), b (4H,), gate order i, f, g, o (flax OptimizedLSTMCell)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.w_x, self.w_h, self.b = lstm_weights_init(in_dim, hidden_dim)

    def sequence(self, x):
        """Hidden states (B, T, H) of the cell run over x (B, T, C) from a
        zero state (the recurrence in float32 under bf16)."""
        return lstm_sequence(x, self.w_x, self.b, self.w_h)

    @staticmethod
    def update(z, c):
        """Gate pre-activations z (B, 4H) and cell c -> (new c, new h)."""
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


def prenet_dropout_scales(shape, p: float, generator, device,
                          dtype=torch.float32):
    """Multipliers for the fed-back frames of a prenet-less decoder:
    1 / (1 - p) where a unit is kept (probability 1 - p), 0 where dropped,
    in the ``dtype`` of the frames they scale.  Drawn from a CPU
    ``generator`` and moved to ``device``, so one seed gives the same masks
    on every device."""
    keep = torch.rand(shape, generator=generator) < (1.0 - p)
    return (keep.to(dtype) / (1.0 - p)).to(device)


class _ARDecoderCore(nn.Module):
    """Decoder LSTM cells ``cell{i}`` and the bias-free ``feat_out``
    projection; :meth:`forward` runs the whole inference loop and
    :meth:`teacher_forced` the decoder over known targets."""

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
                                           generator, enc.device, enc.dtype)
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
            res = lf0_residual(raw)
            lf0 = (lf0_den[:, t] + res - self.out_lf0_mean) / self.out_lf0_scale
            out = out.clone()
            out[..., self.out_lf0_idx] = lf0
            prev = out[:, -1, :]
            outs.append(out)
            ress.append(res)
        return torch.stack(outs, dim=1), torch.stack(ress, dim=1)

    def teacher_forced(self, enc, tgt, lf0_den, generator=None):
        """enc (B, T, C) reduced-rate encoder outputs, tgt (B, T, D) the
        targets at the reduced rate, lf0_den (B, T, r) -> outs
        (B, T, r, D), res (B, T, r).  The fed-back frames pass through
        Bernoulli dropout with p = ``prenet_dropout`` (masks from
        ``generator``)."""
        B, T, _ = enc.shape
        D, r = self.out_dim, self.r
        fed = torch.cat([tgt.new_zeros(B, 1, D), tgt[:, :-1]], dim=1)
        if self.prenet_dropout > 0 and generator is None:
            raise ValueError("prenet dropout needs a torch.Generator")
        h = torch.cat([enc, dropout(fed, self.prenet_dropout, generator)],
                      dim=-1)
        for i in range(self.layers):
            h = getattr(self, f"cell{i}").sequence(h)
        out = self.feat_out(torch.cat([h, enc], dim=-1)).reshape(
            B, T, D, r).transpose(2, 3)
        k = self.out_lf0_idx
        res = lf0_residual(out[..., k])
        lf0 = (lf0_den + res - self.out_lf0_mean) / self.out_lf0_scale
        out = torch.cat([out[..., :k], lf0[..., None].to(out.dtype),
                         out[..., k + 1:]], dim=-1)
        return out, res


def ar_decode(parent, encoder_outs, in_lf0_idx: int, lf0_params,
              generator=None, targets=None):
    """Residual-F0 AR decode for a decoder module ``parent`` that owns
    ``conv_downsample`` (the depthwise stride-r conv that takes the
    encoder to the reduced rate) and ``ar_core``: free-running inference,
    or teacher-forced over ``targets`` (B, T, D), of which every r-th frame
    (``[:, r-1::r]``) is the reduced-rate target.

    encoder_outs (B, T, C) -> (outs (B, T, D), lf0_residual (B, T, 1)).
    """
    r = parent.reduction_factor
    B, T_orig, _ = encoder_outs.shape
    pad = (-T_orig) % r
    if pad:
        encoder_outs = F.pad(encoder_outs, (0, 0, 0, pad))
        if targets is not None:
            targets = F.pad(targets, (0, 0, 0, pad))
    in_lf0_min, in_lf0_max = lf0_params
    lf0_score = encoder_outs[:, :, in_lf0_idx]
    lf0_den = (lf0_score * (in_lf0_max - in_lf0_min) + in_lf0_min).reshape(
        B, -1, r)
    enc = parent.conv_downsample(encoder_outs.transpose(1, 2)).transpose(1, 2)
    lf0_den = lf0_den[:, : enc.shape[1]]
    if targets is None:
        outs, res = parent.ar_core(enc, lf0_den, generator)
    else:
        outs, res = parent.ar_core.teacher_forced(
            enc, targets[:, r - 1:: r].to(enc.dtype), lf0_den, generator)
    T = enc.shape[1]
    outs = outs.reshape(B, T * r, -1)[:, :T_orig]
    return outs, res.reshape(B, T * r, 1)[:, :T_orig]
