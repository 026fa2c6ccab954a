"""Duration-informed autoregressive decoder: the counterpart of
``_ARDecoderCore`` and ``ar_decode`` in
``ensemble_svs_with_interactions_tpu/models/tacotron.py``.

Inference is a Python loop over the T / r reduced steps.  The parts of
each step that do not depend on the fed-back frame (the encoder's share of
the first cell's input projection and of the output projection) are
computed for all steps in one matmul before the loop.

Teacher forcing (training, or evaluation with targets) feeds back the
previous target frame, the go frame (``initial_value``, 0 in the
residual-F0 decoders) at the first step.  Without zoneout
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

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    MaskedBatchNorm,
    dropout,
    lstm_sequence,
    lstm_weights_init,
    time_mask,
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
    :meth:`teacher_forced` the decoder over known targets.  With
    ``residual_f0`` the output's ``out_lf0_idx`` column is the score's
    log-F0 plus a bounded residual; without, the residuals are zeros.
    The first fed frame is ``initial_value`` everywhere."""

    def __init__(self, enc_dim: int, out_dim: int, layers: int,
                 hidden_dim: int, prenet_dropout: float,
                 reduction_factor: int, out_lf0_idx: int = 0,
                 out_lf0_mean: float = 0.0, out_lf0_scale: float = 1.0,
                 residual_f0: bool = True, initial_value: float = 0.0):
        super().__init__()
        self.out_dim, self.layers = out_dim, layers
        self.hidden_dim, self.r = hidden_dim, reduction_factor
        self.prenet_dropout = prenet_dropout
        self.out_lf0_idx = out_lf0_idx
        self.out_lf0_mean, self.out_lf0_scale = out_lf0_mean, out_lf0_scale
        self.residual_f0, self.initial_value = residual_f0, initial_value
        for i in range(layers):
            setattr(self, f"cell{i}",
                    LSTMCell(enc_dim + out_dim if i == 0 else hidden_dim,
                             hidden_dim))
        self.feat_out = nn.Linear(hidden_dim + enc_dim,
                                  out_dim * reduction_factor, bias=False)

    def forward(self, enc, lf0_den, generator=None):
        """enc (B, T, C) reduced-rate encoder outputs, lf0_den (B, T, r)
        denormalized score log-F0 (None without ``residual_f0``) -> outs
        (B, T, r, D), res (B, T, r)."""
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
        prev = enc.new_full((B, D), self.initial_value)
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
            if self.residual_f0:
                raw = out[..., self.out_lf0_idx]
                res = lf0_residual(raw)
                lf0 = ((lf0_den[:, t] + res - self.out_lf0_mean)
                       / self.out_lf0_scale)
                out = out.clone()
                out[..., self.out_lf0_idx] = lf0
            else:
                res = out.new_zeros(B, r)
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
        fed = torch.cat([tgt.new_full((B, 1, D), self.initial_value),
                         tgt[:, :-1]], dim=1)
        if self.prenet_dropout > 0 and generator is None:
            raise ValueError("prenet dropout needs a torch.Generator")
        h = torch.cat([enc, dropout(fed, self.prenet_dropout, generator)],
                      dim=-1)
        for i in range(self.layers):
            h = getattr(self, f"cell{i}").sequence(h)
        out = self.feat_out(torch.cat([h, enc], dim=-1)).reshape(
            B, T, D, r).transpose(2, 3)
        if not self.residual_f0:
            return out, out.new_zeros(B, T, r)
        k = self.out_lf0_idx
        res = lf0_residual(out[..., k])
        lf0 = (lf0_den + res - self.out_lf0_mean) / self.out_lf0_scale
        out = torch.cat([out[..., :k], lf0[..., None].to(out.dtype),
                         out[..., k + 1:]], dim=-1)
        return out, res


def ar_decode(parent, encoder_outs, in_lf0_idx=None, lf0_params=None,
              generator=None, targets=None):
    """AR decode for a decoder module ``parent`` that owns
    ``conv_downsample`` (the depthwise stride-r conv that takes the
    encoder to the reduced rate; None takes every r-th frame, or every
    frame at r = 1) and ``ar_core``: free-running inference, or
    teacher-forced over ``targets`` (B, T, D), of which every r-th frame
    (``[:, r-1::r]``) is the reduced-rate target.  With ``lf0_params``
    (in_lf0_min, in_lf0_max) the decode is residual-F0 around the score
    log-F0 at ``in_lf0_idx`` of the encoder outputs.

    encoder_outs (B, T, C) -> (outs (B, T, D), lf0_residual (B, T, 1), or
    None without residual F0).
    """
    r = parent.reduction_factor
    B, T_orig, _ = encoder_outs.shape
    pad = (-T_orig) % r
    if pad:
        encoder_outs = F.pad(encoder_outs, (0, 0, 0, pad))
        if targets is not None:
            targets = F.pad(targets, (0, 0, 0, pad))
    if parent.conv_downsample is not None:
        enc = parent.conv_downsample(
            encoder_outs.transpose(1, 2)).transpose(1, 2)
    else:
        enc = encoder_outs[:, r - 1:: r]
    T = enc.shape[1]
    lf0_den = None
    if lf0_params is not None:
        in_lf0_min, in_lf0_max = lf0_params
        lf0_score = encoder_outs[:, :, in_lf0_idx]
        lf0_den = (lf0_score * (in_lf0_max - in_lf0_min)
                   + in_lf0_min).reshape(B, -1, r)[:, :T]
    if targets is None:
        outs, res = parent.ar_core(enc, lf0_den, generator)
    else:
        outs, res = parent.ar_core.teacher_forced(
            enc, targets[:, r - 1:: r].to(enc.dtype), lf0_den, generator)
    outs = outs.reshape(B, T * r, -1)[:, :T_orig]
    if lf0_params is None:
        return outs, None
    return outs, res.reshape(B, T * r, 1)[:, :T_orig]


class Postnet(nn.Module):
    """Tacotron 2 Post-Net: ``layers`` bias-free convs (``conv{i}``, zero
    padding (k - 1) / 2, ``channels`` wide, the last back to the input's
    width), each followed by a masked batch norm (``bn{i}``), tanh but
    after the last, and dropout ``dropout`` in training."""

    def __init__(self, in_dim: int, layers: int = 5, channels: int = 512,
                 kernel_size: int = 5, dropout: float = 0.5):
        super().__init__()
        self.layers, self.dropout = layers, dropout
        for i in range(layers):
            cin = in_dim if i == 0 else channels
            cout = in_dim if i == layers - 1 else channels
            setattr(self, f"conv{i}", nn.Conv1d(
                cin, cout, kernel_size, padding=(kernel_size - 1) // 2,
                bias=False))
            setattr(self, f"bn{i}", MaskedBatchNorm(cout))

    def forward(self, x, mask=None, train: bool = False, generator=None):
        for i in range(self.layers):
            x = getattr(self, f"conv{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = getattr(self, f"bn{i}")(x, mask=mask, train=train)
            if i != self.layers - 1:
                x = torch.tanh(x)
            if train and self.dropout > 0:
                x = dropout(x, self.dropout, generator)
        return x


def apply_postnet(parent, outs, lengths, train: bool, generator=None):
    """``[outs, outs + postnet(outs)]``, the coarse and fine outputs the
    trainer supervises both; inference takes the last.  The Post-Net's
    batch statistics cover the valid steps of ``lengths``."""
    mask = time_mask(lengths, outs.shape[1], outs.device)
    return [outs, outs + parent.postnet(outs, mask, train, generator)]


_JAX_TACOTRON = "ensemble_svs_with_interactions_tpu/models/tacotron.py"


def refuse_decoder_options(owner: str, prenet_layers: int = 0,
                           zoneout: float = 0.0, use_mdn: bool = False,
                           prenet_noise_std: float = 0.0):
    """Raise ``NotImplementedError`` for an AR decoder option the port has
    not ported, naming the JAX module that has it."""
    refused = {
        "prenet_layers > 0": (prenet_layers > 0, "Prenet"),
        "zoneout > 0": (zoneout > 0, "zoneout_blend"),
        "use_mdn": (use_mdn, "_ARDecoderCore's MDN head"),
        "prenet_noise_std > 0": (prenet_noise_std > 0,
                                 "_ARDecoderCore's prenet noise"),
    }
    for option, (on, where) in refused.items():
        if on:
            raise NotImplementedError(
                f"{owner} with {option} needs {_JAX_TACOTRON} ({where}), "
                "which the port has not ported")


class NonAttentiveDecoder(BaseModel):
    """Duration-informed Tacotron decoder without attention over encoder
    outputs (B, T, ``in_dim``): the downsampling to the reduced rate, the
    AR decoder core from the go frame ``initial_value``, and with
    ``postnet_layers > 0`` the residual Post-Net (``[coarse, fine]``).
    Refused options raise (:func:`refuse_decoder_options`)."""

    def __init__(self, in_dim: int = 512, out_dim: int = 80, layers: int = 2,
                 hidden_dim: int = 1024, prenet_layers: int = 2,
                 prenet_hidden_dim: int = 256, prenet_dropout: float = 0.5,
                 zoneout: float = 0.1, reduction_factor: int = 1,
                 downsample_by_conv: bool = False, init_type: str = "none",
                 initial_value: float = 0.0, use_mdn: bool = False,
                 num_gaussians: int = 8, sampling_mode: str = "mean",
                 prenet_noise_std: float = 0.0, eval_dropout: bool = True,
                 postnet_layers: int = 0, postnet_channels: int = 512,
                 postnet_kernel_size: int = 5, postnet_dropout: float = 0.0):
        super().__init__()
        refuse_decoder_options(type(self).__name__, prenet_layers, zoneout,
                               use_mdn, prenet_noise_std)
        add_ar_decoder(self, in_dim, out_dim, layers, hidden_dim,
                       prenet_dropout, reduction_factor, downsample_by_conv,
                       initial_value, postnet_layers, postnet_channels,
                       postnet_kernel_size, postnet_dropout)

    def is_autoregressive(self) -> bool:
        return True

    def prediction_type(self):
        return PredictionType.DETERMINISTIC

    def forward(self, encoder_outs, lengths=None, y=None, train: bool = False,
                generator=None):
        return decode_and_refine(self, encoder_outs, lengths, y, train,
                                 generator)

    def inference(self, x, lengths=None, generator=None):
        outs = self(x, lengths, generator=generator)
        return outs[-1] if isinstance(outs, list) else outs


def add_ar_decoder(module, enc_dim: int, out_dim: int, layers: int,
                   hidden_dim: int, prenet_dropout: float,
                   reduction_factor: int, downsample_by_conv: bool,
                   initial_value: float, postnet_layers: int,
                   postnet_channels: int, postnet_kernel_size: int,
                   postnet_dropout: float):
    """Give ``module`` the non-residual AR decoder over ``enc_dim``-wide
    encoder outputs: ``conv_downsample`` (None unless r > 1 with
    ``downsample_by_conv``), ``ar_core`` and, with ``postnet_layers > 0``,
    ``postnet`` (else None)."""
    module.reduction_factor = reduction_factor
    module.conv_downsample = (
        nn.Conv1d(enc_dim, enc_dim, reduction_factor,
                  stride=reduction_factor, groups=enc_dim)
        if reduction_factor > 1 and downsample_by_conv else None)
    module.ar_core = _ARDecoderCore(
        enc_dim, out_dim, layers, hidden_dim, prenet_dropout,
        reduction_factor, residual_f0=False,
        initial_value=float(initial_value))
    module.postnet = (Postnet(out_dim, postnet_layers, postnet_channels,
                              postnet_kernel_size, postnet_dropout)
                      if postnet_layers > 0 else None)


def decode_and_refine(module, encoder_outs, lengths, y, train: bool,
                      generator):
    """The non-residual AR decode of a module built by
    :func:`add_ar_decoder`, then its Post-Net where it has one."""
    outs, _ = ar_decode(module, encoder_outs, generator=generator, targets=y)
    if module.postnet is not None:
        return apply_postnet(module, outs, lengths, train, generator)
    return outs
