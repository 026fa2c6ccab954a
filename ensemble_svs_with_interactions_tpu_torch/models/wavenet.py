"""Conditional WaveNet over frame features, the counterpart of
``ensemble_svs_with_interactions_tpu/models/wavenet.py``: a stack of
causal dilated gated convolutions conditioned by 1x1 projections of the
features, teacher-forced on the target shifted right by one frame.
Feature-last (B, T, C), as in the JAX package; plain torch convolutions,
as the JAX package leaves them to XLA."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import BaseModel


def _conv(conv, x):
    return conv(x.transpose(1, 2)).transpose(1, 2)


class _ResSkipBlock(nn.Module):
    """A causal dilated conv (``Conv_0``) plus the condition's 1x1
    projection (``Conv_1``), a tanh * sigmoid gate, 1x1 skip (``Conv_2``)
    and residual (``Conv_3``) outputs; the residual is added plainly
    (no sqrt(0.5) scaling)."""

    def __init__(self, residual_channels: int, gate_channels: int,
                 kernel_size: int, skip_channels: int, dilation: int,
                 cin_channels: int):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.Conv_0 = nn.Conv1d(residual_channels, gate_channels,
                                kernel_size, dilation=dilation)
        self.Conv_1 = nn.Conv1d(cin_channels, gate_channels, 1)
        self.Conv_2 = nn.Conv1d(gate_channels // 2, skip_channels, 1)
        self.Conv_3 = nn.Conv1d(gate_channels // 2, residual_channels, 1)

    def forward(self, x, c):
        h = self.Conv_0(F.pad(x.transpose(1, 2), (self.pad, 0)))
        h = h.transpose(1, 2) + _conv(self.Conv_1, c)
        a, b = h.chunk(2, dim=-1)
        h = torch.tanh(a) * torch.sigmoid(b)
        return x + _conv(self.Conv_3, h), _conv(self.Conv_2, h)


class WaveNet(BaseModel):
    """Gated dilated conv stack conditioned on frame features: the input
    1x1 conv (``Conv_0``) of the shifted target, ``layers`` blocks
    (``block{i}``, dilation 2 ** (i mod layers / stacks)), ReLU of the
    summed skips, a 1x1 conv with ReLU (``Conv_1``) and the output 1x1
    conv (``Conv_2``)."""

    def __init__(self, in_dim: int = 334, out_dim: int = 206,
                 layers: int = 10, stacks: int = 1,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_out_channels: int = 64, kernel_size: int = 3):
        super().__init__()
        self.out_dim, self.layers = out_dim, layers
        self.Conv_0 = nn.Conv1d(out_dim, residual_channels, 1)
        per_stack = layers // stacks
        for i in range(layers):
            setattr(self, f"block{i}", _ResSkipBlock(
                residual_channels, gate_channels, kernel_size,
                skip_out_channels, 2 ** (i % per_stack), in_dim))
        self.Conv_1 = nn.Conv1d(skip_out_channels, skip_out_channels, 1)
        self.Conv_2 = nn.Conv1d(skip_out_channels, out_dim, 1)

    def is_autoregressive(self) -> bool:
        return True

    def forward(self, c, lengths=None, y=None, train: bool = False,
                generator=None):
        """c (B, T, in_dim) conditioning, y (B, T, out_dim) the target
        (zeros without one), in the JAX model's ``(c, lengths, x)`` order;
        the target is shifted right one frame."""
        B, T = c.shape[0], c.shape[1]
        if y is None:
            y = torch.zeros((B, T, self.out_dim), dtype=c.dtype,
                            device=c.device)
        h = _conv(self.Conv_0, F.pad(y, (0, 0, 1, 0))[:, :-1])
        skips = 0.0
        for i in range(self.layers):
            h, skip = getattr(self, f"block{i}")(h, c)
            skips = skips + skip
        out = torch.relu(_conv(self.Conv_1, torch.relu(skips)))
        return _conv(self.Conv_2, out)

    def inference(self, c, lengths=None, num_time_steps: Optional[int] = None):
        """One forward pass with a zero target, as the JAX model's."""
        return self(c)
