"""The postfilters' GAN discriminator (``Conv2dD`` of
``ensemble_svs_with_interactions_tpu/models/discriminators.py``): a 2-D
conv stack over (B, T, D) features taken as a 1-channel image.

The convolutions run on NCHW images (B, C, T, D); the feature maps are
returned in flax's NHWC layout (B, T', D', C), as views, so that a loss
reads the time axis where the JAX package's does.  They run in float32 with
TF32 off (``utils/precision.conv_precision``), as every convolution of the
port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import BaseModel
from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
    conv_precision,
)

# (channels as a multiple of ``channels``, stride along T) of the four
# feature convolutions
_LAYERS = ((1, 1), (2, 2), (4, 2), (2, 2))


def _leaky_relu(x, slope: float = 0.2):
    """flax's ``leaky_relu``, ``where(x >= 0, x, slope * x)``: its gradient
    at 0 is 1 (torch's is ``slope``), which matters where a zero bias meets
    zero-padded frames."""
    return torch.where(x >= 0, x, slope * x)


def _conv(conv: nn.Conv2d, h):
    """``conv(h)``; an image smaller than the kernel along T or D gives an
    empty map, as XLA's convolution does, where torch's raises."""
    out = [(n + 2 * p - k) // s + 1 for n, p, k, s in zip(
        h.shape[2:], conv.padding, conv.kernel_size, conv.stride)]
    if min(out) > 0 and min(h.shape[2:]) > 0:
        return conv(h)
    return h.new_zeros((h.shape[0], conv.out_channels,
                        *(max(n, 0) for n in out)))


class Conv2dD(BaseModel):
    """Four convolutions (strides 1, 2, 2, 2 along T), each followed by a
    leaky ReLU (0.2) and returned as a feature map, then a 1-channel logit
    map (optionally through a sigmoid), returned last.  ``padding`` None
    pads ((kh - 1) // 2, (kw - 1) // 2); ``in_dim`` is the config's and
    unused (the convolutions take any width)."""

    def __init__(self, in_dim: Optional[int] = None, channels: int = 64,
                 kernel_size: Sequence[int] = (5, 3),
                 padding: Optional[Sequence[int]] = (0, 0),
                 last_sigmoid: bool = False,
                 init_type: str = "kaiming_normal"):
        super().__init__()
        kh, kw = (int(k) for k in kernel_size)
        if padding is None:
            padding = ((kh - 1) // 2, (kw - 1) // 2)
        self.padding = tuple(int(p) for p in padding)
        self.last_sigmoid, self.init_type = last_sigmoid, init_type
        c_in = 1
        for i, (mult, stride) in enumerate(_LAYERS):
            setattr(self, f"Conv_{i}", nn.Conv2d(
                c_in, mult * channels, (kh, kw), stride=(stride, 1),
                padding=self.padding))
            c_in = mult * channels
        self.Conv_4 = nn.Conv2d(c_in, 1, (kh, kw), padding=self.padding)

    def forward(self, x, c=None, lengths=None, train: bool = False):
        """(B, T, D) -> [4 feature maps, logits], each (B, T', D', C)."""
        feats = []
        with conv_precision(x.device):
            h = x.unsqueeze(1)
            for i in range(len(_LAYERS)):
                h = _leaky_relu(_conv(getattr(self, f"Conv_{i}"), h))
                feats.append(h)
            h = _conv(self.Conv_4, h)
        if self.last_sigmoid:
            h = torch.sigmoid(h)
        feats.append(h)
        return [f.permute(0, 2, 3, 1) for f in feats]
