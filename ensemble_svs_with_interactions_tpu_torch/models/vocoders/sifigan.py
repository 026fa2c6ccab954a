"""SiFiGAN and HiFiGAN generators for serving (counterparts in
``ensemble_svs_with_interactions_tpu/models/vocoders/sifigan.py``).

A HiFiGAN-like filter path upsamples the frame features (repeat, then a
zero-padded conv of width 2 * scale + 1, then the mean of multi-dilation
residual blocks per stage); SiFiGAN adds a source path that strides the
sine excitation down to each stage's rate and runs it through a
quasi-periodic block (pitch-dependent taps, ``usfgan.pd_indexing``) before
adding it in.  Layouts as in ``usfgan.py``: (B, T, C) at the boundary,
(B, C, T) inside, flax scope names on the submodules.  ``forward`` returns
the waveform; SiFiGAN's ``train_outputs`` also runs the source head
(``qp_out``, ``source_out``) and returns the JAX ``__call__``'s
(waveform, source) pair.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import BaseModel
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.usfgan import (
    pd_indexing,
)

__all__ = ["HiFiGANGenerator", "SiFiGANGenerator"]


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _same(cin, cout, k, dilation=1):
    """A conv with flax's "SAME" zero padding (odd ``k``)."""
    return nn.Conv1d(cin, cout, k, dilation=dilation,
                     padding=(k - 1) // 2 * dilation)


class _ResBlock(nn.Module):
    """HiFiGAN-style dilated residual block (leaky-relu convs
    ``conv{i}a`` / ``conv{i}b``)."""

    def __init__(self, channels, kernel_size=3, dilations=(1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, dil in enumerate(dilations):
            self.add_module(f"conv{i}a", _same(channels, channels,
                                               kernel_size, dil))
            self.add_module(f"conv{i}b", _same(channels, channels,
                                               kernel_size))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv{i}a")(_lrelu(x))
            x = x + getattr(self, f"conv{i}b")(_lrelu(h))
        return x


class _QPResBlock(nn.Module):
    """Quasi-periodic residual block: pitch-dependent past and future taps
    mixed with the center tap."""

    def __init__(self, channels):
        super().__init__()
        for name in ("convC", "convP", "convF", "convO"):
            self.add_module(name, nn.Conv1d(channels, channels, 1))

    def forward(self, x, d):
        h = _lrelu(x)
        xP, xF = pd_indexing(h, d, 1)
        h = self.convC(h).add_(self.convP(xP)).add_(self.convF(xF))
        return x + self.convO(_lrelu(h))


class _FilterStages(nn.Module):
    """conv_pre and the upsampling stages (``up{li}``, ``res{li}_{bi}``)
    shared by both generators."""

    def __init__(self, channels, aux_channels, upsample_scales,
                 resblock_kernel_sizes, resblock_dilations):
        super().__init__()
        self.scales = [int(s) for s in upsample_scales]
        self.n_res = len(resblock_kernel_sizes)
        self.conv_pre = _same(aux_channels, channels, 7)
        ch, self.widths = channels, []
        for li, scale in enumerate(self.scales):
            prev, ch = ch, max(ch // 2, 8)
            self.widths.append(ch)
            self.add_module(f"up{li}", _same(prev, ch, 2 * scale + 1))
            for bi, (k, dl) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilations)):
                self.add_module(f"res{li}_{bi}",
                                _ResBlock(ch, k, tuple(dl)))

    def up(self, li, h):
        h = torch.repeat_interleave(_lrelu(h), self.scales[li], dim=2)
        return getattr(self, f"up{li}")(h)

    def res(self, li, h):
        out = getattr(self, f"res{li}_0")(h)
        for bi in range(1, self.n_res):
            out = out + getattr(self, f"res{li}_{bi}")(h)
        return out / self.n_res


class SiFiGANGenerator(_FilterStages, BaseModel):
    """Source-filter HiFiGAN generator."""

    def __init__(self, in_channels=1, out_channels=1, channels=128,
                 aux_channels=80, upsample_scales=(5, 4, 3, 2),
                 resblock_kernel_sizes=(3, 7),
                 resblock_dilations=((1, 3, 5), (1, 3, 5))):
        super().__init__(channels, aux_channels, upsample_scales,
                         resblock_kernel_sizes, resblock_dilations)
        src = channels // 4
        self.source_in = nn.Conv1d(in_channels, src, 1)
        for li, ch in enumerate(self.widths):
            self.add_module(f"source_proj{li}", nn.Conv1d(src, ch, 1))
            self.add_module(f"qp{li}", _QPResBlock(ch))
        self.conv_post = _same(self.widths[-1], out_channels, 7)
        self.qp_out = _QPResBlock(src)
        self.source_out = nn.Conv1d(src, out_channels, 1)

    def _filter(self, x, c, d):
        """(waveform (B, T, out), source embedding (B, C / 4, T), d)."""
        T = x.shape[1]
        assert T == c.shape[1] * int(np.prod(self.scales)), (x.shape,
                                                            c.shape)
        s = self.source_in(x.transpose(1, 2))
        d = d.to(torch.float32)
        h = self.conv_pre(c.transpose(1, 2))
        rate = c.shape[1]
        for li, scale in enumerate(self.scales):
            rate *= scale
            h = self.up(li, h)
            stride = T // rate
            s_l = s[:, :, ::stride][:, :, :rate]
            d_l = d[:, ::stride][:, :rate] / stride
            s_l = getattr(self, f"qp{li}")(
                getattr(self, f"source_proj{li}")(s_l), d_l)
            h = self.res(li, h + s_l)
        wav = torch.tanh(self.conv_post(_lrelu(h)))
        return wav.transpose(1, 2), s, d

    def train_outputs(self, x, c, d):
        """(waveform, source signal), each (B, T, out): the JAX
        ``__call__``'s pair."""
        wav, s, d = self._filter(x, c, d)
        src = self.source_out(_lrelu(self.qp_out(s, d)))
        return wav, src.transpose(1, 2)

    def forward(self, x, c, d):
        """x (B, T, S) excitation, c (B, T', aux), d (B, T) -> waveform
        (B, T, out)."""
        return self._filter(x, c, d)[0]

    def inference(self, x, c, d):
        return self(x, c, d)


class HiFiGANGenerator(_FilterStages, BaseModel):
    """HiFiGAN generator: frame features -> waveform (the filter path of
    :class:`SiFiGANGenerator` without the source)."""

    def __init__(self, out_channels=1, channels=512, aux_channels=80,
                 upsample_scales=(8, 8, 2, 2),
                 resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5))):
        super().__init__(channels, aux_channels, upsample_scales,
                         resblock_kernel_sizes, resblock_dilations)
        self.conv_post = _same(self.widths[-1], out_channels, 7)

    def forward(self, c):
        """c (B, T', aux) -> (B, T' * prod(scales), out)."""
        h = self.conv_pre(c.transpose(1, 2))
        for li in range(len(self.scales)):
            h = self.res(li, self.up(li, h))
        return torch.tanh(self.conv_post(_lrelu(h))).transpose(1, 2)

    def inference(self, c):
        if c.dim() == 2:
            return self(c[None])[0, :, 0]
        return self(c)[..., 0]

