"""Postfilters (counterparts in
``ensemble_svs_with_interactions_tpu/models/postfilters.py``): the host
GV postfilter and the learned conv postfilters that a recipe packs as
``postfilter_model`` (``Conv2dPostFilter``, the ``MultistreamPostFilter``
that ``bin/merge_postfilters.py`` writes, and the mel voices'
``MelF0MultistreamPostFilter``).

The conv postfilter takes (B, T, D) features and runs its convolutions on
NCHW images (B, C, T, D); its submodules carry the flax scope names
(``conv1``-``conv4``, ``fc``), so ``utils/flax_port`` carries the weights
both ways.  Its noise is drawn at the input's (padded) shape from a CPU
``torch.Generator`` and moved to the input's device, so the card and the
CPU see the same noise; tests pass it in as ``noise``.

The convolutions run in float32 with TF32 off, as every convolution of the
port and as the JAX package computes them: a 5 x 5 convolution over 129
channels in TF32 sits about 1e-3 from float32.
``utils/precision.conv_precision`` says so to cuDNN around each CUDA call.

``MultistreamConv2dPostFilter`` splits the mel-cepstrum into low, mid and
high bands that overlap by the kernel's half width, each through its own
reflection-padded conv stack (``_PadConv2dPostFilter``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import BaseModel
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import shard_draw
from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
    conv_precision,
)


def variance_scaling(gv, feats, offset: int = 2, note_frame_indices=None):
    """Global-variance postfilter: rescale each dim's utterance variance
    (over ``note_frame_indices`` when given) to the training data's ``gv``;
    the first ``offset`` dims are left as they are.  Host NumPy."""
    feats = np.asarray(feats)
    gv = np.asarray(gv)
    if note_frame_indices is not None:
        if len(note_frame_indices) == 0:
            return feats
        sel = feats[note_frame_indices]
    else:
        sel = feats
    utt_gv = sel.var(0)
    utt_mu = sel.mean(0)
    out = feats.copy()
    scale = np.sqrt(gv[offset:] / np.maximum(utt_gv[offset:], 1e-12))
    if note_frame_indices is not None:
        out[note_frame_indices[:, None],
            np.arange(offset, feats.shape[1])[None, :]] = (
            scale * (feats[note_frame_indices][:, offset:] - utt_mu[offset:])
            + utt_mu[offset:])
    else:
        out[:, offset:] = (scale * (feats[:, offset:] - utt_mu[offset:])
                           + utt_mu[offset:])
    return out


def moving_average(x: torch.Tensor, width: int) -> torch.Tensor:
    """Moving average of (B, T, C) over time, reflection-padded by
    (width - 1) // 2 before and width // 2 after (``MovingAverage1d``);
    needs T > width // 2."""
    pad = (width - 1) // 2
    xp = F.pad(x.transpose(1, 2), (pad, width - 1 - pad), mode="reflect")
    return F.avg_pool1d(xp, width, stride=1).transpose(1, 2)


def draw_noise(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normal noise on the CPU from ``generator`` (a generator
    seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return shard_draw(lambda s: torch.randn(s, generator=generator), shape, 0)


class Conv2dPostFilter(BaseModel):
    """Kaneko-style GAN postfilter on (B, T, D) features treated as
    images: noise as a second image channel (``bin_wise``, one value per
    bin, or ``frame_wise``, one per frame spread over the bins by ``fc``),
    four conv blocks each re-concatenating the input, residual output.
    The moving-average smoother applies to the noise, at inference only.

    ``in_dim`` (D) is needed for ``frame_wise`` noise; a
    ``MultistreamPostFilter`` sets it from its stream sizes.  ``init_type``
    names the flax scheme of the kernels that ``utils/flax_init`` draws
    for training."""

    def __init__(self, channels: int = 128,
                 kernel_size: Sequence[int] = (5, 5),
                 init_type: str = "kaiming_normal", noise_scale: float = 1.0,
                 noise_type: str = "bin_wise", smoothing_width: int = -1,
                 in_dim: Optional[int] = None):
        super().__init__()
        if noise_type not in ("bin_wise", "frame_wise"):
            raise ValueError(f"unknown noise type: {noise_type}")
        self.noise_scale = noise_scale
        self.noise_type = noise_type
        self.init_type = init_type
        self.smoothing_width = smoothing_width
        kh, kw = kernel_size
        c = channels
        conv = dict(kernel_size=(kh, kw), padding=(kh // 2, kw // 2))
        self.conv1 = nn.Conv2d(2, c, **conv)
        self.conv2 = nn.Conv2d(c + 1, c * 2, **conv)
        self.conv3 = nn.Conv2d(c * 2 + 1, c, **conv)
        self.conv4 = nn.Conv2d(c + 1, 1, **conv)
        self.in_dim = None
        if in_dim is not None:
            self.set_in_dim(in_dim)

    def set_in_dim(self, in_dim: int):
        """Fix the feature width D (builds ``fc`` for frame-wise noise)."""
        self.in_dim = int(in_dim)
        if self.noise_type == "frame_wise":
            self.fc = nn.Linear(1, self.in_dim)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                is_inference: bool = False, noise=None, generator=None):
        """(B, T, D) -> (B, T, D).  ``noise``: the standard normal draw,
        (B, T, D) for bin-wise noise, (B, T, 1) for frame-wise; else drawn
        from ``generator``."""
        B, T, D = x.shape
        if noise is None:
            noise = draw_noise(
                (B, T, D if self.noise_type == "bin_wise" else 1), generator)
        z = noise.to(x.device, x.dtype) * self.noise_scale
        if is_inference and self.smoothing_width > 0:
            z = moving_average(z, self.smoothing_width)
        with conv_precision(x.device):
            if self.noise_type == "frame_wise":
                if self.in_dim != D:
                    raise ValueError(f"frame-wise noise built for in_dim "
                                     f"{self.in_dim}, input has {D} dims")
                z = self.fc(z)
            x_img = x.unsqueeze(1)
            h = torch.relu(self.conv1(torch.cat([x_img, z.unsqueeze(1)], 1)))
            h = torch.relu(self.conv2(torch.cat([x_img, h], 1)))
            h = torch.relu(self.conv3(torch.cat([x_img, h], 1)))
            residual = self.conv4(torch.cat([x_img, h], 1))[:, 0]
        return x + residual

    def inference(self, x, lengths=None, noise=None, generator=None):
        return self(x, lengths, is_inference=True, noise=noise,
                    generator=generator)


class MultistreamPostFilter(BaseModel):
    """Each stream (mgc, lf0, vuv, bap) through its own postfilter; the
    first ``mgc_offset`` mgc dims (and ``bap_offset`` bap dims) pass
    through, V/UV is untouched.  Noise is drawn in the order mgc, bap,
    lf0, from one generator; ``noise`` may give it per stream as
    ``{"mgc": ..., "bap": ..., "lf0": ...}``."""

    def __init__(self, mgc_postfilter: Optional[nn.Module] = None,
                 bap_postfilter: Optional[nn.Module] = None,
                 lf0_postfilter: Optional[nn.Module] = None,
                 stream_sizes: Sequence[int] = (60, 1, 1, 5),
                 mgc_offset: int = 2, bap_offset: int = 0):
        super().__init__()
        if len(stream_sizes) != 4:
            raise ValueError(f"unsupported streams: {len(stream_sizes)}")
        self.stream_sizes = [int(s) for s in stream_sizes]
        self.mgc_offset = mgc_offset
        self.bap_offset = bap_offset
        self.mgc_postfilter = mgc_postfilter
        self.bap_postfilter = bap_postfilter
        self.lf0_postfilter = lf0_postfilter
        dims = {"mgc": self.stream_sizes[0] - mgc_offset,
                "bap": self.stream_sizes[3] - bap_offset,
                "lf0": self.stream_sizes[1]}
        for name, dim in dims.items():
            pf = getattr(self, f"{name}_postfilter")
            if pf is not None and hasattr(pf, "set_in_dim"):
                pf.set_in_dim(dim)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                is_inference: bool = False, noise=None, generator=None):
        noise = noise or {}

        def run(name, s):
            pf = getattr(self, f"{name}_postfilter")
            if pf is None:
                return s
            return pf(s, lengths, train=train, is_inference=is_inference,
                      noise=noise.get(name), generator=generator)

        def run_after(name, s, offset):
            return torch.cat([s[..., :offset], run(name, s[..., offset:])],
                             dim=-1)

        mgc, lf0, vuv, bap = torch.split(x, self.stream_sizes, dim=-1)
        mgc = run_after("mgc", mgc, self.mgc_offset)
        bap = run_after("bap", bap, self.bap_offset)
        lf0 = run("lf0", lf0)
        return torch.cat([mgc, lf0, vuv, bap], dim=-1)

    def inference(self, x, lengths=None, noise=None, generator=None):
        return self(x, lengths, is_inference=True, noise=noise,
                    generator=generator)


class MelF0MultistreamPostFilter(BaseModel):
    """The mel voices' postfilter: mel (past its first ``mel_offset``
    dims) and lf0 each through their own postfilter where one is given,
    V/UV untouched.  Noise is drawn in the order mel, lf0, from one
    generator; ``noise`` may give it per stream as ``{"mel": ...,
    "lf0": ...}``."""

    def __init__(self, mel_postfilter: Optional[nn.Module] = None,
                 lf0_postfilter: Optional[nn.Module] = None,
                 stream_sizes: Sequence[int] = (80, 1, 1),
                 mel_offset: int = 0):
        super().__init__()
        if len(stream_sizes) != 3:
            raise ValueError(f"unsupported streams: {len(stream_sizes)}")
        self.stream_sizes = [int(s) for s in stream_sizes]
        self.mel_offset = mel_offset
        self.mel_postfilter = mel_postfilter
        self.lf0_postfilter = lf0_postfilter
        for pf, dim in ((mel_postfilter, self.stream_sizes[0] - mel_offset),
                        (lf0_postfilter, self.stream_sizes[1])):
            if pf is not None and hasattr(pf, "set_in_dim"):
                pf.set_in_dim(dim)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                is_inference: bool = False, noise=None, generator=None):
        noise = noise or {}

        def run(name, s):
            pf = getattr(self, f"{name}_postfilter")
            if pf is None:
                return s
            return pf(s, lengths, train=train, is_inference=is_inference,
                      noise=noise.get(name), generator=generator)

        mel, lf0, vuv = torch.split(x, self.stream_sizes, dim=-1)
        off = self.mel_offset
        mel = torch.cat([mel[..., :off], run("mel", mel[..., off:])], dim=-1)
        return torch.cat([mel, run("lf0", lf0), vuv], dim=-1)

    def inference(self, x, lengths=None, noise=None, generator=None):
        return self(x, lengths, is_inference=True, noise=noise,
                    generator=generator)


def _reflect_pad2d(x, top: int, bottom: int, left: int, right: int):
    """Reflection-pad a (B, C, T, D) image on T (top / bottom) and D (left /
    right)."""
    return F.pad(x, (left, right, top, bottom), mode="reflect")


class _PadConv2dPostFilter(nn.Module):
    """One band of ``MultistreamConv2dPostFilter``: the feature axis is
    reflection-padded on one side only (``padding_side``), so adjacent
    bands overlap by the convolution's half width; every convolution is
    unpadded after the reflection.  ``forward(x (B, T, in_dim), z (B, T,
    1))`` gives the band without its overlap columns."""

    def __init__(self, in_dim: int, channels: int = 128,
                 kernel_size: int = 5, init_type: str = "kaiming_normal",
                 padding_side: str = "left"):
        super().__init__()
        if padding_side not in ("left", "none", "right"):
            raise ValueError("Invalid padding side")
        self.pad = (kernel_size - 1) // 2
        self.padding_side, self.init_type = padding_side, init_type
        ks, c = kernel_size, channels
        self.fc = nn.Linear(1, in_dim)
        self.conv1 = nn.Conv2d(2, c, (ks, ks))
        self.conv2 = nn.Conv2d(c + 1, c * 2, (ks, 3))
        self.conv3 = nn.Conv2d(c * 2 + 1, c, (ks, 3))
        self.conv4 = nn.Conv2d(c + 1, 1, (ks, 1))

    def forward(self, x, z):
        pad = self.pad
        lr = {"left": (pad, 0), "none": (0, 0),
              "right": (0, pad)}[self.padding_side]
        x_img, z_img = x.unsqueeze(1), self.fc(z).unsqueeze(1)
        h = torch.cat([_reflect_pad2d(x_img, pad, pad, *lr),
                       _reflect_pad2d(z_img, pad, pad, *lr)], 1)
        h = torch.relu(self.conv1(h))
        # the band's output drops the overlap columns conv1 ate
        if self.padding_side == "left":
            x_syn = x_img[..., :-pad]
        elif self.padding_side == "none":
            x_syn = x_img[..., pad:-pad]
        else:
            x_syn = x_img[..., pad:]

        def conv(h, layer):
            side = (layer.kernel_size[1] - 1) // 2
            return layer(_reflect_pad2d(torch.cat([x_syn, h], 1), pad, pad,
                                        side, side))

        h = torch.relu(conv(h, self.conv2))
        h = torch.relu(conv(h, self.conv3))
        return (x_syn + conv(h, self.conv4))[:, 0]


class MultistreamConv2dPostFilter(BaseModel):
    """Conv2d mel-cepstrum postfilter split into low, mid and high bands
    (``stream_sizes``) with kernel-width overlaps, all three driven by one
    frame-wise noise draw (``noise`` (B, T, 1), else drawn from
    ``generator``).  ``in_dim`` is the config's and unused."""

    def __init__(self, in_dim: Optional[int] = None, channels: int = 128,
                 kernel_size: int = 5, init_type: str = "kaiming_normal",
                 noise_scale: float = 1.0,
                 stream_sizes: Sequence[int] = (8, 20, 30)):
        super().__init__()
        if len(stream_sizes) != 3:
            raise ValueError("MultistreamConv2dPostFilter takes 3 bands")
        self.stream_sizes = [int(s) for s in stream_sizes]
        self.noise_scale, self.init_type = noise_scale, init_type
        pad = (kernel_size - 1) // 2
        kw = dict(channels=channels, kernel_size=kernel_size,
                  init_type=init_type)
        s0, s1, s2 = self.stream_sizes
        self.low_postfilter = _PadConv2dPostFilter(s0 + pad, **kw,
                                                   padding_side="left")
        self.mid_postfilter = _PadConv2dPostFilter(s1 + 2 * pad, **kw,
                                                   padding_side="none")
        self.high_postfilter = _PadConv2dPostFilter(s2 + pad, **kw,
                                                    padding_side="right")

    def forward(self, x, lengths=None, y=None, train: bool = False,
                is_inference: bool = False, noise=None, generator=None):
        """(B, T, D) -> (B, T, D), D the sum of ``stream_sizes``."""
        B, T, D = x.shape
        if D != sum(self.stream_sizes):
            raise ValueError(f"input has {D} dims, the bands "
                             f"{self.stream_sizes}")
        if noise is None:
            noise = draw_noise((B, T, 1), generator)
        z = noise.to(x.device, x.dtype) * self.noise_scale
        pad = self.low_postfilter.pad
        s0, s1, _ = self.stream_sizes
        with conv_precision(x.device):
            return torch.cat([
                self.low_postfilter(x[:, :, : s0 + pad], z),
                self.mid_postfilter(x[:, :, s0 - pad: s0 + s1 + pad], z),
                self.high_postfilter(x[:, :, s0 + s1 - pad:], z)], dim=-1)

    def inference(self, x, lengths=None, noise=None, generator=None):
        return self(x, lengths, noise=noise, generator=generator)
