"""Reusable layers: masked (bi)LSTMs over the hand-written recurrence
kernels, masked batch norm, dropout, reflection-padded convs and the
phoneme-context embedding.  Counterparts of
``ensemble_svs_with_interactions_tpu/models/layers.py``.

Features are (B, T, C), feature-last, as in the JAX package.  Submodules
carry the flax scope names (``Dense_0``, ``LSTM_0``, ``l0_fwd`` ...) so
that ``utils.flax_port.flax_to_torch`` maps weights by path.

Training is selected per call with ``train=True``, as in the JAX package
(the module's own ``training`` flag is not read), and random masks come
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence,
    lstm_recurrence_trainable,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    all_reduce_sum_autograd,
    shard_draw,
)


def recurrence(xw, w_h):
    """The LSTM recurrence over input projections ``xw``: through the
    differentiable :class:`ops.lstm_recurrence.LSTMRecurrence` (forward
    and BPTT kernels on the card) whenever a gradient is required, the
    forward alone otherwise."""
    if torch.is_grad_enabled() and (xw.requires_grad or w_h.requires_grad):
        return lstm_recurrence_trainable(xw, w_h)
    return lstm_recurrence(xw, w_h)


def lstm_sequence(x, w_x, b, w_h):
    """Hidden states (B, T, H) of an LSTM run over x (B, T, C) from a zero
    state.  The input projection ``x @ w_x + b`` runs in x's dtype.  Under
    bf16 mixed precision the recurrence still runs in float32 (xw and W_h
    cast up, the hidden states cast back), as the JAX package keeps its
    LSTM carry (``ops/pallas_lstm.py`` ``lstm_layer_pallas_trainable``): a
    bf16 carry loses accuracy over long sequences."""
    xw = torch.matmul(x, w_x) + b
    if x.dtype == torch.bfloat16:
        return recurrence(xw.float(), w_h.float()).to(x.dtype)
    return recurrence(xw, w_h)


def dropout(x, p: float, generator):
    """flax ``nn.Dropout`` in training: keep each unit with probability
    1 - p and scale it by 1 / (1 - p).  The mask is drawn on the
    ``generator``'s device and moved to ``x``'s (a batch shard's rows of
    the whole batch's mask, ``parallel.mesh.shard_draw``; x batch first)."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = shard_draw(lambda s: torch.rand(s, generator=generator,
                                           device=generator.device),
                      x.shape, 0) < (1.0 - p)
    return torch.where(keep.to(x.device), x / (1.0 - p), torch.zeros_like(x))


def reverse_padded(x, lengths):
    """Reverse each (B, T, ...) sequence within its own valid length.

    Padded tail positions receive copies of valid frames (callers mask
    them), as in the JAX package."""
    T = x.shape[1]
    idx = lengths[:, None] - 1 - torch.arange(T, device=x.device)[None, :]
    idx = idx.clamp(0, T - 1)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def lstm_weights_init(in_dim: int, hidden_dim: int):
    """(w_x (C, 4H), w_h (H, 4H), b (4H,)) drawn like torch's nn.LSTM,
    uniform in +-1/sqrt(H); gate order i, f, g, o."""
    bound = hidden_dim ** -0.5
    return (
        nn.Parameter(torch.empty(in_dim, 4 * hidden_dim).uniform_(-bound,
                                                                   bound)),
        nn.Parameter(torch.empty(hidden_dim, 4 * hidden_dim).uniform_(-bound,
                                                                       bound)),
        nn.Parameter(torch.empty(4 * hidden_dim).uniform_(-bound, bound)),
    )


class _MaskedLSTMLayer(nn.Module):
    """Single-direction LSTM over (B, T, C), outputs zeroed at pad steps.

    The input projection ``x @ w_x + b`` for all steps is one matmul; the
    recurrence runs in :func:`ops.lstm_recurrence.lstm_recurrence` (the
    Hopper kernel on the card), in float32 under bf16
    (:func:`lstm_sequence`).  The recurrence runs through the padded
    suffix unmasked: padding is a suffix for both directions (the backward
    direction is reversed within each length first), so valid steps are
    exactly those of the JAX package's masked scan, and the rest is
    zeroed here.
    """

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.w_x, self.w_h, self.b = lstm_weights_init(in_dim, hidden_dim)

    def forward(self, x, mask):
        return (lstm_sequence(x, self.w_x, self.b, self.w_h)
                * mask[:, :, None].to(x.dtype))


class LSTM(nn.Module):
    """Multi-layer (bi)LSTM with mask-based variable lengths, matching torch
    ``nn.LSTM`` over packed sequences: outputs at padded steps are zero and
    the backward direction starts at each sequence's own last valid frame.
    With ``train=True``, dropout ``dropout`` applies between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 1,
                 bidirectional: bool = True, dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        width = in_dim
        for layer in range(num_layers):
            setattr(self, f"l{layer}_fwd", _MaskedLSTMLayer(width, hidden_dim))
            if bidirectional:
                setattr(self, f"l{layer}_bwd",
                        _MaskedLSTMLayer(width, hidden_dim))
            width = hidden_dim * (2 if bidirectional else 1)
        self.out_dim = width

    def forward(self, x, lengths=None, train: bool = False, generator=None):
        B, T = x.shape[0], x.shape[1]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long, device=x.device)
        mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        h = x
        for layer in range(self.num_layers):
            fwd = getattr(self, f"l{layer}_fwd")(h, mask)
            if self.bidirectional:
                bwd = getattr(self, f"l{layer}_bwd")(
                    reverse_padded(h, lengths), mask)
                h = torch.cat([fwd, reverse_padded(bwd, lengths)], dim=-1)
            else:
                h = fwd
            if train and layer < self.num_layers - 1:
                h = dropout(h, self.dropout, generator)
        return h * mask[:, :, None].to(h.dtype)


def time_mask(lengths, T: int, device):
    """(B, T) bool mask of valid steps, or None without lengths."""
    if lengths is None:
        return None
    return torch.arange(T, device=device)[None, :] < lengths[:, None]


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (B, T, C).  At inference it uses the running
    statistics.  With ``train=True`` it normalizes with the batch's
    statistics over the valid steps of ``mask`` (biased variance,
    E[x^2] - E[x]^2) and updates the running ones in place, in the flax
    convention ``running = momentum * running + (1 - momentum) * batch``,
    with the Bessel-corrected variance over the valid count.  Under a
    process group the count, sum and sum of squares are summed over the
    ranks first (the gradient flows back through the sums), so every rank
    normalises, and updates its running statistics, with the global
    batch's, as the JAX package's global-view program does."""

    momentum = 0.9

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask=None, train: bool = False):
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            m = (torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
                 if mask is None else mask.to(x.dtype))[:, :, None]
            count = torch.clamp(all_reduce_sum(m.sum()), min=1.0)
            mean = all_reduce_sum_autograd((x * m).sum(dim=(0, 1))) / count
            var = torch.clamp(
                all_reduce_sum_autograd((x * x * m).sum(dim=(0, 1))) / count
                - mean * mean, min=0.0)
            with torch.no_grad():
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                self.running_mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * unbiased)
        inv = torch.rsqrt(var + self.epsilon)
        return (x - mean) * inv * self.weight + self.bias


def leaky_relu(x, slope: float = 0.2):
    """flax's ``leaky_relu``, ``where(x >= 0, x, slope * x)``: its gradient
    at 0 is 1, where torch's is ``slope``."""
    return torch.where(x >= 0, x, slope * x)


def reflect_pad(x, pad: int):
    """``F.pad(x, (pad, pad), mode="reflect")`` on the last axis, built
    from flipped slices: the same values, and a backward that sums each
    position's gradients in a fixed order (reflection_pad1d's backward on
    the card accumulates them with atomics, so a training run would not
    repeat bitwise)."""
    return torch.cat([x[..., 1: pad + 1].flip(-1), x,
                      x[..., -pad - 1: -1].flip(-1)], dim=-1)


class ReflectConv1d(nn.Module):
    """Conv1d with reflection padding over the time axis of (B, T, C),
    optionally dilated and weight-normed as flax's ``nn.WeightNorm``
    (``Conv_0`` is then the vocoder discriminators' ``SameConv``, whose
    ``scale`` flax keeps at ``WeightNorm_0``).  ``init_type`` names the
    flax scheme of its kernel (``utils/flax_init``): the model's where the
    JAX model passes it its ``kernel_init``, else ``"none"``
    (lecun_normal)."""

    def __init__(self, in_dim: int, features: int, kernel_size: int,
                 init_type: str = "none", dilation: int = 1,
                 weight_norm: bool = False):
        super().__init__()
        self.pad = (kernel_size - 1) // 2 * dilation
        self.dilation = dilation
        self.init_type = init_type
        if weight_norm:
            from ensemble_svs_with_interactions_tpu_torch.models.vocoders.discriminators import (  # noqa: E501
                SameConv,
            )

            self.Conv_0 = SameConv(in_dim, features, (kernel_size,),
                                   dilation=(dilation,), weight_norm=True)
        else:
            self.Conv_0 = nn.Conv1d(in_dim, features, kernel_size,
                                    dilation=dilation)

    def forward(self, x):
        h = x.transpose(1, 2)
        if self.pad:
            h = reflect_pad(h, self.pad)
        conv = self.Conv_0
        if isinstance(conv, nn.Conv1d):
            return conv(h).transpose(1, 2)
        return F.conv1d(h, conv.effective_weight(), conv.bias,
                        dilation=self.dilation).transpose(1, 2)


class ResnetBlock(nn.Module):
    """MelGAN-style dilated residual block: leaky ReLU, a weight-normed
    reflection-padded k3 conv at ``dilation`` (``ReflectConv1d_0``), leaky
    ReLU, a weight-normed 1x1 conv (``Conv_0``), plus a weight-normed 1x1
    shortcut of the input (``Conv_1``)."""

    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        from ensemble_svs_with_interactions_tpu_torch.models.vocoders.discriminators import (  # noqa: E501
            SameConv,
        )

        self.ReflectConv1d_0 = ReflectConv1d(dim, dim, 3, dilation=dilation,
                                             weight_norm=True)
        self.Conv_0 = SameConv(dim, dim, (1,), weight_norm=True)
        self.Conv_1 = SameConv(dim, dim, (1,), weight_norm=True)

    def forward(self, x):
        h = leaky_relu(self.ReflectConv1d_0(leaky_relu(x)))
        h = self.Conv_0(h.transpose(1, 2))
        return (self.Conv_1(x.transpose(1, 2)) + h).transpose(1, 2)


class PhonemeContextEmbedding(nn.Module):
    """Replace the one-hot phoneme block of the features with a learned
    embedding: ``emb(argmax(onehot)) + fc([leading | trailing])``.
    ``in_dim`` is the width of the features it is applied to."""

    def __init__(self, in_dim: int, embed_dim: int, in_ph_start_idx: int = 1,
                 in_ph_end_idx: int = 50):
        super().__init__()
        self.start, self.end = in_ph_start_idx, in_ph_end_idx
        self.Embed_0 = nn.Embedding(in_ph_end_idx - in_ph_start_idx, embed_dim)
        self.Dense_0 = nn.Linear(in_dim - (in_ph_end_idx - in_ph_start_idx),
                                 embed_dim)

    def forward(self, x):
        ph = torch.argmax(x[..., self.start: self.end], dim=-1)
        rest = torch.cat([x[..., : self.start], x[..., self.end:]], dim=-1)
        return self.Embed_0(ph) + self.Dense_0(rest)


class TrTimeInvFIRFilter(nn.Module):
    """Trainable per-channel FIR filter H(z) = sum_k b_k z^-k over (B, T,
    C), the shallow-AR models' analysis filter.  ``taps`` (channels,
    filt_dim), drawn normal / filt_dim; ``tanh`` bounds the coefficients
    in (-1, 1) and ``fixed_0th`` fixes b_0 = 1.  Causal, y[t] = sum_k b_k
    x[t - k], or, when not, shifted by (filt_dim - 1) // 2 frames.
    :meth:`inverse` is the IIR synthesis 1 / H(z), step by step."""

    FLAX_LEAVES = ("taps",)

    def __init__(self, channels: int, filt_dim: int, causal: bool = True,
                 tanh: bool = True, fixed_0th: bool = True):
        super().__init__()
        self.filt_dim, self.causal = filt_dim, causal
        self.tanh, self.fixed_0th = tanh, fixed_0th
        self.taps = nn.Parameter(torch.randn(channels, filt_dim) / filt_dim)

    def coefs(self, dtype=None):
        """(channels, filt_dim) coefficients, index 0 the current sample,
        computed in ``dtype`` (the taps' own by default), as the JAX
        filter computes them from parameters in the step's dtype."""
        b = self.taps if dtype is None else self.taps.to(dtype)
        if self.tanh:
            b = torch.tanh(b)
        if self.fixed_0th:
            b = torch.cat([torch.ones_like(b[:, :1]), b[:, 1:]], dim=1)
        return b

    def forward(self, x):
        b = self.coefs(x.dtype)
        K, T = self.filt_dim, x.shape[1]
        shift = 0 if self.causal else (K - 1) // 2
        x_pad = F.pad(x, (0, 0, K - 1 - shift, shift))
        out = torch.zeros_like(x)
        for k in range(K):
            lo = K - 1 - k
            out = out + b[:, k] * x_pad[:, lo: lo + T]
        return out

    def inverse(self, x):
        """y[t] = x[t] - sum_{k >= 1} b_k y[t - k] from a zero state, in
        time order (causal filters only)."""
        if not self.causal:
            raise ValueError("inverse IIR filtering requires a causal filter")
        b = self.coefs(x.dtype)
        if self.filt_dim == 1:
            return x / b[:, 0]
        taps = b[:, 1:]
        B, T, C = x.shape
        past = torch.zeros((B, self.filt_dim - 1, C), dtype=x.dtype,
                           device=x.device)
        ys = []
        for t in range(T):
            y_t = x[:, t] - torch.einsum("bkc,ck->bc", past, taps)
            past = torch.cat([y_t[:, None], past[:, :-1]], dim=1)
            ys.append(y_t)
        return torch.stack(ys, dim=1)
