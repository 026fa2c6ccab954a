"""Vocoder GAN discriminators (counterparts in
``ensemble_svs_with_interactions_tpu/models/vocoders/discriminators.py``):
Parallel WaveGAN's, HiFiGAN's multi-period and multi-scale ones and
UnivNet's multi-resolution spectral one, alone and combined.

Audio comes in the JAX package's layout, (B, T, 1).  Each discriminator
returns its feature maps with the logits last, in torch's layouts: (B, C,
T) after a 1-D conv, (B, C, H, W) after a 2-D one (the period
discriminators fold time into (T / p, p), the spectral ones convolve over
(frames, bins)); the multi-discriminators return a list of such lists.

Every convolution is a :class:`SameConv`: flax's ``nn.Conv`` with
``padding="SAME"`` (XLA's split of the pad, the odd half after, at any
stride) and, with ``use_weight_norm``, flax's ``nn.WeightNorm`` around it,
``w = scale * v * rsqrt(sum(v ** 2) + 1e-12)`` over every axis but the
output features, ``scale`` starting at ones (torch's ``weight_norm`` has
no epsilon and starts ``g`` at the norm of ``v``).  Submodules carry the
flax scope names (``Conv_{k}``, ``period{p}``, ``scale{i}``, ``spec{i}``,
``msd``, ``mpd``, ``spectral``, ``period``), so ``utils/flax_port``
carries the weights both ways; a weight-normed conv's ``scale`` lives in
flax at the sibling scope ``WeightNorm_{k}`` under the key
``Conv_{k}/kernel/scale``.  ``use_spectral_norm=True`` raises, as the JAX
package refuses it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "SameConv",
    "PWGDiscriminator",
    "HiFiGANPeriodDiscriminator",
    "HiFiGANMultiPeriodDiscriminator",
    "HiFiGANScaleDiscriminator",
    "HiFiGANMultiScaleDiscriminator",
    "HiFiGANMultiScaleMultiPeriodDiscriminator",
    "UnivNetSpectralDiscriminator",
    "UnivNetMultiResolutionSpectralDiscriminator",
    "UnivNetMultiResolutionMultiPeriodDiscriminator",
    "stft_mag",
]

WEIGHT_NORM_EPS = 1e-12


def _activation(name: str, params: Optional[dict], default_slope: float):
    """The activation by the JAX package's names; an empty ``params``
    takes the class's default slope."""
    params = dict(params or {"negative_slope": default_slope})
    if name == "LeakyReLU":
        slope = float(params.get("negative_slope", 0.01))
        return lambda x: F.leaky_relu(x, slope)
    if name == "ReLU":
        return F.relu
    raise ValueError(f"unsupported activation: {name}")


def same_pad(size: int, kernel: int, stride: int, dilation: int = 1):
    """(low, high) zero pad of one axis under XLA's ``"SAME"``."""
    total = max((-(-size // stride) - 1) * stride
                + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Module):
    """A 1-D or 2-D convolution (by ``len(kernel_size)``) with flax's
    ``"SAME"`` padding, optionally weight-normed as flax's
    ``nn.WeightNorm``: ``weight`` is ``v`` (Cout, Cin / groups, *kernel),
    ``scale`` (Cout,) the per-output gain."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int], stride: Sequence[int] = None,
                 dilation: Sequence[int] = None, groups: int = 1,
                 bias: bool = True, weight_norm: bool = True):
        super().__init__()
        k = tuple(int(v) for v in kernel_size)
        self.kernel_size = k
        self.stride = tuple(stride or (1,) * len(k))
        self.dilation = tuple(dilation or (1,) * len(k))
        self.groups = groups
        self.in_channels, self.out_channels = in_channels, out_channels
        self.weight = nn.Parameter(torch.empty(out_channels,
                                               in_channels // groups, *k))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.scale = (nn.Parameter(torch.ones(out_channels)) if weight_norm
                      else None)

    def effective_weight(self) -> torch.Tensor:
        w = self.weight
        if self.scale is None:
            return w
        dims = tuple(range(1, w.dim()))
        w = w * torch.rsqrt((w * w).sum(dims, keepdim=True)
                            + WEIGHT_NORM_EPS)
        return w * self.scale.view(-1, *([1] * (w.dim() - 1)))

    def forward(self, x):
        pads = []
        for size, k, s, d in reversed(list(zip(
                x.shape[2:], self.kernel_size, self.stride, self.dilation))):
            pads.extend(same_pad(size, k, s, d))
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(F.pad(x, pads), self.effective_weight(), self.bias,
                    self.stride, 0, self.dilation, self.groups)


class _Stack(nn.Module):
    """Convs named ``Conv_{k}`` in the order flax creates them."""

    def _add(self, *args, **kw) -> SameConv:
        k = sum(1 for n in self._modules if n.startswith("Conv_"))
        conv = SameConv(*args, **kw)
        self.add_module(f"Conv_{k}", conv)
        return conv

    def convs(self):
        return [m for n, m in self._modules.items() if n.startswith("Conv_")]


def _no_spectral_norm(flag: bool):
    if flag:
        raise NotImplementedError("spectral norm is not supported")


class PWGDiscriminator(_Stack):
    """Parallel WaveGAN's discriminator: stacked dilated convs, dilation 1
    at layer 0, then i (``dilation_factor`` 1) or ``dilation_factor ** i``."""

    def __init__(self, in_channels=1, out_channels=1, layers=10,
                 conv_channels=64, kernel_size=3, dilation_factor=1,
                 bias=True, nonlinear_activation="LeakyReLU",
                 nonlinear_activation_params=None, use_weight_norm=True):
        super().__init__()
        self.act = _activation(nonlinear_activation,
                               nonlinear_activation_params, 0.2)
        ch = in_channels
        for i in range(layers - 1):
            dilation = (1 if i == 0 else i if dilation_factor == 1
                        else dilation_factor ** i)
            self._add(ch, conv_channels, (kernel_size,),
                      dilation=(dilation,), bias=bias,
                      weight_norm=use_weight_norm)
            ch = conv_channels
        self._add(ch, out_channels, (kernel_size,), bias=bias,
                  weight_norm=use_weight_norm)

    def forward(self, x):
        h, feats = x.transpose(1, 2), []
        convs = self.convs()
        for conv in convs[:-1]:
            h = self.act(conv(h))
            feats.append(h)
        feats.append(convs[-1](h))
        return feats


class HiFiGANPeriodDiscriminator(_Stack):
    """Time folded into (T / period, period) and 2-D convs over it; T is
    padded up to a multiple of the period with copies of its last samples
    (not a reflection)."""

    def __init__(self, in_channels=1, out_channels=1, period=3,
                 kernel_sizes=(5, 3), channels=32,
                 max_downsample_channels=1024,
                 downsample_scales=(3, 3, 3, 3, 1), bias=True,
                 nonlinear_activation="LeakyReLU",
                 nonlinear_activation_params=None, use_weight_norm=True,
                 use_spectral_norm=False):
        super().__init__()
        _no_spectral_norm(use_spectral_norm)
        self.period = period
        self.act = _activation(nonlinear_activation,
                               nonlinear_activation_params, 0.1)
        cin, ch = in_channels, channels
        for scale in downsample_scales:
            self._add(cin, ch, (kernel_sizes[0], 1), stride=(scale, 1),
                      bias=bias, weight_norm=use_weight_norm)
            cin, ch = ch, min(ch * 4, max_downsample_channels)
        self._add(cin, out_channels, (max(kernel_sizes[1] - 1, 1), 1),
                  bias=bias, weight_norm=use_weight_norm)

    def forward(self, x):
        B, T, C = x.shape
        pad = (self.period - T % self.period) % self.period
        if pad:
            x = torch.cat([x, x[:, T - pad:T]], dim=1)
        h = x.reshape(B, -1, self.period, C).permute(0, 3, 1, 2)
        feats = []
        convs = self.convs()
        for conv in convs[:-1]:
            h = self.act(conv(h))
            feats.append(h)
        feats.append(convs[-1](h))
        return feats


class HiFiGANMultiPeriodDiscriminator(nn.Module):
    """One period discriminator per period (``period{p}``)."""

    def __init__(self, periods=(2, 3, 5, 7, 11), channels=32,
                 discriminator_params=None):
        super().__init__()
        params = dict(discriminator_params or {"channels": channels})
        params.pop("period", None)
        self.periods = [int(p) for p in periods]
        for p in self.periods:
            self.add_module(f"period{p}",
                            HiFiGANPeriodDiscriminator(period=p, **params))

    def forward(self, x):
        return [getattr(self, f"period{p}")(x) for p in self.periods]


class HiFiGANScaleDiscriminator(_Stack):
    """Grouped 1-D convs; the groups run 4, 16, 64, ... capped at
    ``max_groups``, and a conv whose input width they do not divide takes
    one group."""

    def __init__(self, in_channels=1, out_channels=1,
                 kernel_sizes=(15, 41, 5, 3), channels=128,
                 max_downsample_channels=1024, max_groups=16,
                 downsample_scales=(2, 2, 4, 4, 1), bias=True,
                 nonlinear_activation="LeakyReLU",
                 nonlinear_activation_params=None, use_weight_norm=True,
                 use_spectral_norm=False):
        super().__init__()
        _no_spectral_norm(use_spectral_norm)
        self.act = _activation(nonlinear_activation,
                               nonlinear_activation_params, 0.1)
        k0, k1, k2, k3 = kernel_sizes
        wn = dict(bias=bias, weight_norm=use_weight_norm)
        self._add(in_channels, channels, (k0,), **wn)
        ch, groups = channels, 4
        for scale in downsample_scales:
            ch_next = min(ch * 2, max_downsample_channels)
            g = min(groups, max_groups)
            self._add(ch, ch_next, (k1,), stride=(scale,),
                      groups=g if ch % g == 0 else 1, **wn)
            ch, groups = ch_next, groups * 4
        self._add(ch, ch, (k2,), **wn)
        self._add(ch, out_channels, (k3,), **wn)

    def forward(self, x):
        h, feats = x.transpose(1, 2), []
        convs = self.convs()
        for conv in convs[:-1]:
            h = self.act(conv(h))
            feats.append(h)
        feats.append(convs[-1](h))
        return feats


class HiFiGANMultiScaleDiscriminator(nn.Module):
    """Scale discriminators (``scale{i}``) on the audio average-pooled
    ``i`` times (torch's ``AvgPool1d``: the zero pad counts in the mean)."""

    def __init__(self, scales=3, downsample_pooling="AvgPool1d",
                 downsample_pooling_params=None,
                 downsample_pooling_window=4, downsample_pooling_stride=2,
                 discriminator_params=None, follow_official_norm=False):
        super().__init__()
        if downsample_pooling != "AvgPool1d":
            raise ValueError(f"unsupported pooling: {downsample_pooling}")
        pool = dict(downsample_pooling_params or {})
        self.window = int(pool.get("kernel_size", downsample_pooling_window))
        self.stride = int(pool.get("stride", downsample_pooling_stride))
        self.pad = int(pool.get("padding", 0))
        self.scales = scales
        params = dict(discriminator_params or {})
        for i in range(scales):
            self.add_module(f"scale{i}", HiFiGANScaleDiscriminator(**params))

    def forward(self, x):
        outs, h = [], x
        for i in range(self.scales):
            outs.append(getattr(self, f"scale{i}")(h))
            h = F.avg_pool1d(h.transpose(1, 2), self.window, self.stride,
                             self.pad, count_include_pad=True).transpose(1, 2)
        return outs


class HiFiGANMultiScaleMultiPeriodDiscriminator(nn.Module):
    """The multi-scale (``msd``) then the multi-period (``mpd``) lists."""

    def __init__(self, scales=3, periods=(2, 3, 5, 7, 11),
                 scale_downsample_pooling="AvgPool1d",
                 scale_downsample_pooling_params=None,
                 scale_discriminator_params=None,
                 period_discriminator_params=None,
                 follow_official_norm=False):
        super().__init__()
        self.msd = HiFiGANMultiScaleDiscriminator(
            scales=scales, downsample_pooling=scale_downsample_pooling,
            downsample_pooling_params=scale_downsample_pooling_params,
            discriminator_params=scale_discriminator_params,
            follow_official_norm=follow_official_norm)
        self.mpd = HiFiGANMultiPeriodDiscriminator(
            periods=periods, discriminator_params=period_discriminator_params)

    def forward(self, x):
        return self.msd(x) + self.mpd(x)


_WINDOWS = {"hann_window": np.hanning, "hann": np.hanning,
            "hamming_window": np.hamming, "hamming": np.hamming}


def stft_mag(x: torch.Tensor, fft_size: int, hop: int, win_length: int,
             window: str = "hann_window") -> torch.Tensor:
    """|STFT| of (B, T) -> (B, frames, fft_size // 2 + 1), as the JAX
    package's ``_stft_mag``: (T - win) // hop + 1 frames (at least one)
    starting at 0, hop, ..., not centred, indices past the end clamped to
    the last sample; a symmetric window zero-padded to ``fft_size``;
    ``sqrt(max(|X| ** 2, 1e-9))``."""
    if window not in _WINDOWS:
        raise ValueError(f"unsupported window: {window}")
    T = x.shape[-1]
    n_frames = max((T - win_length) // hop + 1, 1)
    idx = (torch.arange(win_length, device=x.device)[None, :]
           + hop * torch.arange(n_frames, device=x.device)[:, None])
    frames = x[:, idx.clamp(max=T - 1)]
    win = torch.from_numpy(_WINDOWS[window](win_length)).to(x.device,
                                                            x.dtype)
    spec = torch.fft.rfft(frames * win, n=fft_size, dim=-1)
    return torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-9))


class UnivNetSpectralDiscriminator(_Stack):
    """2-D "SAME" convs over one resolution's |STFT| (frames, bins); no
    activation after the last."""

    def __init__(self, fft_size=1024, hop_size=120, win_length=600,
                 window="hann_window", channels=32,
                 kernel_sizes=((3, 9), (3, 9), (3, 9), (3, 9), (3, 3),
                               (3, 3)),
                 strides=((1, 1), (1, 2), (1, 2), (1, 2), (1, 1), (1, 1)),
                 bias=True, nonlinear_activation="LeakyReLU",
                 nonlinear_activation_params=None, use_weight_norm=True):
        super().__init__()
        if len(kernel_sizes) != len(strides):
            raise ValueError("kernel_sizes and strides differ in length")
        self.fft_size, self.hop_size = fft_size, hop_size
        self.win_length, self.window = win_length, window
        self.act = _activation(nonlinear_activation,
                               nonlinear_activation_params, 0.2)
        cin = 1
        for i, (ks, st) in enumerate(zip(kernel_sizes, strides)):
            cout = 1 if i == len(kernel_sizes) - 1 else channels
            self._add(cin, cout, tuple(ks), stride=tuple(st), bias=bias,
                      weight_norm=use_weight_norm)
            cin = cout

    def forward(self, x):
        h = stft_mag(x[..., 0], self.fft_size, self.hop_size,
                     self.win_length, self.window)[:, None]
        feats = []
        convs = self.convs()
        for conv in convs[:-1]:
            h = self.act(conv(h))
            feats.append(h)
        feats.append(convs[-1](h))
        return feats


class UnivNetMultiResolutionSpectralDiscriminator(nn.Module):
    """One spectral discriminator per resolution (``spec{i}``)."""

    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window="hann_window",
                 discriminator_params=None):
        super().__init__()
        params = dict(discriminator_params or {})
        self.n = len(fft_sizes)
        for i, (f, h, w) in enumerate(zip(fft_sizes, hop_sizes,
                                          win_lengths)):
            self.add_module(f"spec{i}", UnivNetSpectralDiscriminator(
                fft_size=f, hop_size=h, win_length=w, window=window,
                **params))

    def forward(self, x):
        return [getattr(self, f"spec{i}")(x) for i in range(self.n)]


class UnivNetMultiResolutionMultiPeriodDiscriminator(nn.Module):
    """The multi-resolution spectral (``spectral``) then the multi-period
    (``period``) lists: the hn-uSFGAN recipe's discriminator."""

    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window="hann_window",
                 periods=(2, 3, 5, 7, 11), period_channels=32,
                 spectral_discriminator_params=None,
                 period_discriminator_params=None):
        super().__init__()
        self.spectral = UnivNetMultiResolutionSpectralDiscriminator(
            fft_sizes=tuple(fft_sizes), hop_sizes=tuple(hop_sizes),
            win_lengths=tuple(win_lengths), window=window,
            discriminator_params=spectral_discriminator_params)
        self.period = HiFiGANMultiPeriodDiscriminator(
            periods=tuple(periods), discriminator_params=dict(
                period_discriminator_params
                or {"channels": period_channels}))

    def forward(self, x):
        return self.spectral(x) + self.period(x)
