"""Source-filter GAN vocoders for serving (counterparts in
``ensemble_svs_with_interactions_tpu/models/vocoders/usfgan.py``): uSFGAN,
the harmonic-plus-noise uSFGAN pair (cascade and parallel) and Parallel
WaveGAN's generator, with the host helpers that build their excitation
(``SignalGenerator``, ``dilated_factor``) and ``USFGANWrapper``.

The generators take the JAX package's layouts at their boundary, x
(B, T, S) excitation, c (B, T', aux) frame features and d (B, T)
dilation factors, and return the waveform (B, T, out); inside they run
(B, C, T), so every convolution is an ``nn.Conv1d`` over time.  Their
submodules carry the flax scope names (``upsample``, ``harmonic_network``,
``adaptive{i}``, ``fixed{i}``, ``Conv_{i}``, ...), so ``utils/flax_port``
carries the weights both ways.  The pitch-dependent taps
(:func:`pd_indexing`) are a gather along time with a (B, 1, T) index
expanded over the channels, never materialized at (B, C, T).

``forward`` returns the waveform alone; ``train_outputs`` returns the
JAX ``__call__``'s tuple, which the vocoder losses read (the uSFGAN
source signal; the hn-uSFGAN ``src``, ``h_dbg``, ``n_dbg`` and gates).
The hn-uSFGAN's serving forward mixes its latents in place; its
``train_outputs`` mixes them out of place, as autograd needs.  The
residual blocks' skip convolutions, which the JAX package computes and
discards, keep their weights so a pack loads whole, but are not computed:
they get no gradient.

The convolutions run in float32 with TF32 off, as the JAX package
computes them; ``USFGANWrapper`` and ``VocoderPack`` hold cuDNN to that
around each CUDA call (``utils/precision.conv_precision``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import BaseModel
from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
    conv_precision,
)

_SQRT_HALF = math.sqrt(0.5)


# ------------------------------------------------------------ host helpers
def dilated_factor(f0: np.ndarray, fs: int, dense_factor: int) -> np.ndarray:
    """Pitch-dependent dilation factor per frame: fs / (dense_factor * f0);
    unvoiced frames (f0 == 0) get 1.0."""
    f0 = np.asarray(f0, dtype=np.float64).reshape(-1)
    f0 = np.where(f0 > 0, f0, fs / dense_factor)
    return fs / (dense_factor * f0)


class SignalGenerator:
    """Sample-rate excitation from frame-rate F0 (host NumPy): a
    phase-continuous sine plus noise (``"sine"``), unit Gaussian noise
    (``"noise"``) or the voiced mask (``"uv"``), one channel each."""

    def __init__(self, sample_rate: int = 24000, hop_size: int = 120,
                 sine_amp: float = 0.1, noise_amp: float = 0.003,
                 signal_types: Sequence[str] = ("sine",)):
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.sine_amp = sine_amp
        self.noise_amp = noise_amp
        self.signal_types = list(signal_types)

    def __call__(self, f0: np.ndarray, seed: int = 0) -> np.ndarray:
        """f0: (T, 1) or (T,) frame-rate F0 -> (T*hop, n_signals)."""
        rng = np.random.default_rng(seed)
        f0 = np.asarray(f0, dtype=np.float64).reshape(-1)
        f0_samples = np.repeat(f0, self.hop_size)
        voiced = f0_samples > 0
        sigs = []
        for kind in self.signal_types:
            if kind == "sine":
                phase = 2 * np.pi * np.cumsum(f0_samples) / self.sample_rate
                sig = np.where(voiced, self.sine_amp * np.sin(phase), 0.0)
                if self.noise_amp > 0:
                    # one noise draw: noise_amp voiced, noise_amp / 3 not
                    amp = np.where(voiced, self.noise_amp,
                                   self.noise_amp / 3.0)
                    sig = sig + amp * rng.standard_normal(len(f0_samples))
            elif kind == "noise":
                sig = rng.standard_normal(len(f0_samples))
            elif kind == "uv":
                sig = voiced.astype(np.float64)
            else:
                raise ValueError(f"unknown signal type: {kind}")
            sigs.append(sig)
        return np.stack(sigs, axis=-1).astype(np.float32)


# ------------------------------------------------------------ device parts
def pd_index(d: torch.Tensor, dilation: int):
    """The taps of :func:`pd_indexing`: (past index, past valid, future
    index, future valid), each (B, 1, T), at t -/+ rint(d * dilation)
    (float32, round half to even, as the JAX package rounds)."""
    T = d.shape[-1]
    offs = torch.round(d * dilation).to(torch.int64)
    t = torch.arange(T, device=d.device)
    raw_p, raw_f = t - offs, t + offs
    return (raw_p.clamp(0, T - 1)[:, None], (raw_p >= 0)[:, None],
            raw_f.clamp(0, T - 1)[:, None], (raw_f <= T - 1)[:, None])


def _gather(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor):
    out = torch.gather(x, 2, idx.expand(-1, x.shape[1], -1))
    return out.masked_fill_(~valid, 0.0)


def pd_indexing(x: torch.Tensor, d: torch.Tensor, dilation: int, taps=None):
    """Pitch-dependent past and future taps of x (B, C, T) at t -/+
    rint(d * dilation), d (B, T); taps out of range read as zero.
    ``taps``: :func:`pd_index`'s result, when the caller shares it."""
    idx_p, ok_p, idx_f, ok_f = taps or pd_index(d, dilation)
    return _gather(x, idx_p, ok_p), _gather(x, idx_f, ok_f)


def _gated(h: torch.Tensor) -> torch.Tensor:
    xa, xb = h.chunk(2, dim=1)
    return torch.tanh(xa) * torch.sigmoid(xb)


class _FixedBlock(nn.Module):
    """Reflect-padded dilated conv, gated tanh x sigmoid with the aux 1x1,
    residual and skip 1x1s (flax ``Conv_0`` .. ``Conv_3``)."""

    def __init__(self, residual_channels, gate_channels, skip_channels,
                 aux_channels, kernel_size=3, dilation=1):
        super().__init__()
        self.pad = (kernel_size - 1) // 2 * dilation
        self.Conv_0 = nn.Conv1d(residual_channels, gate_channels,
                                kernel_size, dilation=dilation)
        self.Conv_1 = nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        self.Conv_2 = nn.Conv1d(gate_channels // 2, skip_channels, 1)
        self.Conv_3 = nn.Conv1d(gate_channels // 2, residual_channels, 1)

    def forward(self, x, c, want_skip: bool = False):
        h = self.Conv_0(F.pad(x, (self.pad, self.pad), mode="reflect"))
        h = _gated(h.add_(self.Conv_1(c)))
        out = self.Conv_3(h).add_(x).mul_(_SQRT_HALF)
        return (out, self.Conv_2(h)) if want_skip else out


class _AdaptiveBlock(nn.Module):
    """Pitch-adaptive block: center, past and future 1x1s (``convC``,
    ``convP``, ``convF``), the aux 1x1 and the gate, residual and skip
    1x1s."""

    def __init__(self, residual_channels, gate_channels, skip_channels,
                 aux_channels):
        super().__init__()
        self.convC = nn.Conv1d(residual_channels, gate_channels, 1)
        self.convP = nn.Conv1d(residual_channels, gate_channels, 1)
        self.convF = nn.Conv1d(residual_channels, gate_channels, 1)
        self.Conv_0 = nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        self.Conv_1 = nn.Conv1d(gate_channels // 2, skip_channels, 1)
        self.Conv_2 = nn.Conv1d(gate_channels // 2, residual_channels, 1)

    def forward(self, xC, xP, xF, c):
        h = self.convC(xC).add_(self.convP(xP)).add_(self.convF(xF))
        h = _gated(h.add_(self.Conv_0(c)))
        return self.Conv_2(h).add_(xC).mul_(_SQRT_HALF)


class _ResidualBlocks(nn.Module):
    """``blockA`` adaptive and ``blockF`` fixed blocks in ``cycleA`` /
    ``cycleF`` dilation cycles (adaptive first unless ``cascade_mode``);
    returns the residual path, as the JAX package does."""

    def __init__(self, blockA, cycleA, blockF, cycleF, cascade_mode=0,
                 residual_channels=64, gate_channels=128, skip_channels=64,
                 aux_channels=80):
        super().__init__()
        per_a = max(blockA // max(cycleA, 1), 1)
        per_f = max(blockF // max(cycleF, 1), 1)
        modes = ([True] * blockA + [False] * blockF if cascade_mode == 0
                 else [False] * blockF + [True] * blockA)
        widths = (residual_channels, gate_channels, skip_channels,
                  aux_channels)
        self.order = []
        a_idx = f_idx = 0
        for adaptive in modes:
            if adaptive:
                name, dilation = f"adaptive{a_idx}", 2 ** (a_idx % per_a)
                self.add_module(name, _AdaptiveBlock(*widths))
                a_idx += 1
            else:
                name, dilation = f"fixed{f_idx}", 2 ** (f_idx % per_f)
                self.add_module(name, _FixedBlock(*widths,
                                                  dilation=dilation))
                f_idx += 1
            self.order.append((name, adaptive, dilation))

    def forward(self, x, c, d, taps: Optional[Dict] = None):
        """x (B, C, T), c (B, aux, T), d (B, T); ``taps`` caches
        :func:`pd_index` by dilation across calls that share d."""
        taps = {} if taps is None else taps
        for name, adaptive, dilation in self.order:
            block = getattr(self, name)
            if adaptive:
                if dilation not in taps:
                    taps[dilation] = pd_index(d, dilation)
                xP, xF = pd_indexing(x, d, dilation, taps[dilation])
                x = block(x, xP, xF, c)
            else:
                x = block(x, c)
        return x


class _ConvInUpsampleNetwork(nn.Module):
    """Edge-padded context conv over the frames, then per scale a nearest
    repeat and a zero-padded ("SAME") conv of width 2 * scale + 1."""

    def __init__(self, upsample_scales, aux_channels, aux_context_window=2):
        super().__init__()
        self.window = aux_context_window
        self.scales = [int(s) for s in upsample_scales]
        self.Conv_0 = nn.Conv1d(aux_channels, aux_channels,
                                2 * aux_context_window + 1, bias=False)
        for i, s in enumerate(self.scales):
            self.add_module(f"Conv_{i + 1}", nn.Conv1d(
                aux_channels, aux_channels, 2 * s + 1, padding=s,
                bias=False))

    def forward(self, c):
        """c (B, aux, T') -> (B, aux, T' * prod(scales))."""
        c = self.Conv_0(F.pad(c, (self.window, self.window),
                              mode="replicate"))
        for i, s in enumerate(self.scales):
            c = getattr(self, f"Conv_{i + 1}")(
                torch.repeat_interleave(c, s, dim=2))
        return c


def _upsample_scales(upsample_params):
    ups = dict(upsample_params or {"upsample_scales": [5, 4, 3, 2]})
    return ups["upsample_scales"]


def _to_bct(x, c, d):
    return (x.transpose(1, 2), c.transpose(1, 2),
            d.to(torch.float32))


class USFGANGenerator(BaseModel):
    """Source network (pitch-adaptive blocks) -> excitation; filter network
    (fixed dilated blocks) -> waveform."""

    def __init__(self, source_network_params=None,
                 filter_network_params=None, in_channels=1, out_channels=1,
                 residual_channels=64, gate_channels=128, skip_channels=64,
                 aux_channels=80, aux_context_window=2, upsample_params=None,
                 use_weight_norm=True):
        super().__init__()
        src = dict(source_network_params or {
            "blockA": 30, "cycleA": 3, "blockF": 0, "cycleF": 0,
            "cascade_mode": 0})
        filt = dict(filter_network_params or {
            "blockA": 0, "cycleA": 0, "blockF": 30, "cycleF": 3,
            "cascade_mode": 0})
        common = dict(residual_channels=residual_channels,
                      gate_channels=gate_channels,
                      skip_channels=skip_channels, aux_channels=aux_channels)
        self.upsample = _ConvInUpsampleNetwork(
            _upsample_scales(upsample_params), aux_channels,
            aux_context_window)
        self.conv_first = nn.Conv1d(in_channels, residual_channels, 1)
        self.source_network = _ResidualBlocks(**src, **common)
        self.source_mid = nn.Conv1d(residual_channels, skip_channels, 1)
        self.source_out = nn.Conv1d(skip_channels, out_channels, 1)
        self.conv_mid = nn.Conv1d(out_channels, skip_channels, 1)
        self.filter_network = _ResidualBlocks(**filt, **common)
        self.filter_mid = nn.Conv1d(residual_channels, skip_channels, 1)
        self.filter_out = nn.Conv1d(skip_channels, out_channels, 1)

    def train_outputs(self, x, c, d):
        """(waveform, source signal), each (B, T, out): the JAX
        ``__call__``'s tuple."""
        x, c, d = _to_bct(x, c, d)
        c_up = self.upsample(c)
        taps = {}
        h = self.source_network(self.conv_first(x), c_up, d, taps)
        s = self.source_out(torch.relu(self.source_mid(torch.relu(h))))
        h = self.filter_network(self.conv_mid(s), c_up, d, taps)
        out = self.filter_out(torch.relu(self.filter_mid(torch.relu(h))))
        return out.transpose(1, 2), s.transpose(1, 2)

    def forward(self, x, c, d):
        """x (B, T, in), c (B, T', aux), d (B, T) -> waveform (B, T, out)."""
        return self.train_outputs(x, c, d)[0]

    def inference(self, x, c, d):
        return self(x, c, d)


class PeriodicityEstimator(nn.Module):
    """Edge-padded conv stack giving per-sample periodicity gates in
    [0, 1] (relu between, sigmoid after the last conv)."""

    def __init__(self, in_channels, out_channels=64, conv_layers=3,
                 kernel_size=5, dilation=1):
        super().__init__()
        self.pad = kernel_size // 2 * dilation
        self.n = conv_layers
        for idx in range(conv_layers):
            self.add_module(f"conv{idx}", nn.Conv1d(
                in_channels if idx == 0 else out_channels, out_channels,
                kernel_size, dilation=dilation))

    def forward(self, c):
        h = c
        for idx in range(self.n):
            h = getattr(self, f"conv{idx}")(
                F.pad(h, (self.pad, self.pad), mode="replicate"))
            h = torch.sigmoid(h) if idx == self.n - 1 else torch.relu(h)
        return h


class _HnUSFGANBase(BaseModel):
    """Harmonic-plus-noise uSFGAN: a harmonic (adaptive) network on the
    sine, a noise network on the noise, mixed by the periodicity gates,
    then a filter network; ``in_channels`` is each excitation's width
    (x holds the sine and the noise side by side)."""

    _CASCADE = False

    def __init__(self, harmonic_network_params=None,
                 noise_network_params=None, filter_network_params=None,
                 periodicity_estimator_params=None, in_channels=1,
                 out_channels=1, residual_channels=64, gate_channels=128,
                 skip_channels=64, aux_channels=80, aux_context_window=2,
                 upsample_params=None, use_weight_norm=True):
        super().__init__()
        harm = dict(harmonic_network_params or {
            "blockA": 20, "cycleA": 4, "blockF": 0, "cycleF": 0,
            "cascade_mode": 0})
        noise = dict(noise_network_params or {
            "blockA": 0, "cycleA": 0, "blockF": 5, "cycleF": 5,
            "cascade_mode": 0})
        filt = dict(filter_network_params or {
            "blockA": 0, "cycleA": 0, "blockF": 30, "cycleF": 3,
            "cascade_mode": 0})
        pest = dict(periodicity_estimator_params or {
            "conv_layers": 3, "kernel_size": 5, "dilation": 1})
        common = dict(residual_channels=residual_channels,
                      gate_channels=gate_channels,
                      skip_channels=skip_channels, aux_channels=aux_channels)
        R = residual_channels
        self.upsample = _ConvInUpsampleNetwork(
            _upsample_scales(upsample_params), aux_channels,
            aux_context_window)
        self.periodicity_estimator = PeriodicityEstimator(
            aux_channels, out_channels=skip_channels,
            conv_layers=int(pest.get("conv_layers",
                                     pest.get("conv_blocks", 3))),
            kernel_size=int(pest.get("kernel_size", 5)),
            dilation=int(pest.get("dilation", 1)))
        self.conv_first_sine = nn.Conv1d(in_channels, R, 1)
        self.conv_first_noise = nn.Conv1d(in_channels, R, 1)
        self.harmonic_network = _ResidualBlocks(**harm, **common)
        if self._CASCADE:
            self.conv_merge = nn.Conv1d(2 * R, R, 1)
        else:
            self.conv_noise_proj = nn.Conv1d(R, R, 1)
        self.noise_network = _ResidualBlocks(**noise, **common)
        self.conv_filter_in = nn.Conv1d(R, R, 1)
        self.filter_network = _ResidualBlocks(**filt, **common)
        self.last_mid = nn.Conv1d(skip_channels, skip_channels, 1)
        self.last_out = nn.Conv1d(skip_channels, out_channels, 1)

    def _latent(self, x, c, d, keep: bool):
        """(upsampled c, d, taps, gates a, source latent s, gated h, gated
        n), (B, C, T) inside.  ``keep`` mixes out of place and returns h
        and n; otherwise in place, with h and n None."""
        x, c, d = _to_bct(x, c, d)
        c_up = self.upsample(c)
        a = self.periodicity_estimator(c_up)
        sine, noise_in = x.chunk(2, dim=1)
        taps = {}
        h = self.harmonic_network(self.conv_first_sine(sine), c_up, d, taps)
        n = self.conv_first_noise(noise_in)
        h = h * a if keep else h.mul_(a)
        if self._CASCADE:
            n = self.conv_merge(torch.cat([h, n], dim=1))
        else:
            n = self.conv_noise_proj(n)
        n = self.noise_network(n, c_up, d, taps)
        if keep:
            n = (1.0 - a) * n
            return c_up, d, taps, a, h + n, h, n
        # s = a * h + (1 - a) * n
        s = torch.addcmul(h.add_(n), a, n, value=-1.0)
        return c_up, d, taps, a, s, None, None

    def _head(self, z):
        """The output head shared by the waveform and the source."""
        return self.last_out(torch.relu(self.last_mid(torch.relu(z))))

    def train_outputs(self, x, c, d, debug: bool = False):
        """The JAX ``__call__``'s tuple (waveform, source, harmonic debug,
        noise debug, gates), (B, T, C) each: the debug heads run on
        detached latents, and only with ``debug`` (else None)."""
        c_up, d, taps, a, s, h, n = self._latent(x, c, d, keep=True)
        wav = self._head(self.filter_network(self.conv_filter_in(s), c_up,
                                             d, taps))
        dbg = ((self._head(h.detach()).transpose(1, 2),
                self._head(n.detach()).transpose(1, 2)) if debug
               else (None, None))
        return (wav.transpose(1, 2), self._head(s).transpose(1, 2), *dbg,
                a.transpose(1, 2))

    def forward(self, x, c, d):
        """x (B, T, 2 * in) [sine, noise], c (B, T', aux), d (B, T) ->
        waveform (B, T, out)."""
        c_up, d, taps, _, s, _, _ = self._latent(x, c, d, keep=False)
        x = self.filter_network(self.conv_filter_in(s), c_up, d, taps)
        return self._head(x).transpose(1, 2)

    def inference(self, x, c, d):
        return self(x, c, d)


class CascadeHnUSFGANGenerator(_HnUSFGANBase):
    """Cascade hn-uSFGAN: the gated harmonic latent feeds the noise
    network through a merge conv."""

    _CASCADE = True


class ParallelHnUSFGANGenerator(_HnUSFGANBase):
    """Parallel hn-uSFGAN: harmonic and noise networks run independently
    and are mixed by the periodicity gates."""

    _CASCADE = False


def draw_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise on ``generator``'s device."""
    return torch.randn(shape, generator=generator, device=generator.device)


class PWGGenerator(BaseModel):
    """Parallel WaveGAN generator: a non-causal WaveNet of fixed blocks
    over the upsampled conditioning, driven by noise."""

    def __init__(self, in_channels=1, out_channels=1, layers=30, stacks=3,
                 residual_channels=64, gate_channels=128, skip_channels=64,
                 aux_channels=80, aux_context_window=2, kernel_size=3,
                 upsample_scales=(5, 4, 3, 2)):
        super().__init__()
        self.layers = layers
        self.up = int(np.prod(list(upsample_scales)))
        per_stack = layers // stacks
        self.upsample = _ConvInUpsampleNetwork(
            list(upsample_scales), aux_channels, aux_context_window)
        self.conv_first = nn.Conv1d(in_channels, residual_channels, 1)
        for layer in range(layers):
            self.add_module(f"block{layer}", _FixedBlock(
                residual_channels, gate_channels, skip_channels,
                aux_channels, kernel_size=kernel_size,
                dilation=2 ** (layer % per_stack)))
        self.conv_out1 = nn.Conv1d(skip_channels, skip_channels, 1)
        self.conv_out2 = nn.Conv1d(skip_channels, out_channels, 1)

    def forward(self, x, c):
        """x (B, T, 1) noise, c (B, T', aux) -> waveform (B, T, out)."""
        x, c = x.transpose(1, 2), c.transpose(1, 2)
        c_up = self.upsample(c)
        h = self.conv_first(x)
        skips = 0.0
        for layer in range(self.layers):
            h, s = getattr(self, f"block{layer}")(h, c_up, want_skip=True)
            skips = s if layer == 0 else skips.add_(s)
        out = torch.relu(skips * math.sqrt(1.0 / self.layers))
        out = self.conv_out2(torch.relu(self.conv_out1(out)))
        return out.transpose(1, 2)

    def inference(self, c, generator: Optional[torch.Generator] = None):
        """Frame features (T', aux) or (B, T', aux) -> waveform (B, T); the
        noise from ``generator`` (by default one on c's device seeded 0,
        so each call draws the same noise)."""
        if c.dim() == 2:
            c = c[None]
        if generator is None:
            generator = torch.Generator(c.device).manual_seed(0)
        x = draw_noise((c.shape[0], c.shape[1] * self.up, 1), generator)
        return self(x.to(c.dtype), c)[..., 0]


class USFGANWrapper:
    """Frame F0 and aux features -> waveform: the excitation (seed 0 on
    every call) and the dilation factors are built on the host, the
    generator runs on ``device`` and the waveform comes back to the
    host."""

    def __init__(self, module: nn.Module, sample_rate: int = 24000,
                 hop_size: int = 120, sine_amp: float = 0.1,
                 noise_amp: float = 0.003,
                 signal_types: Sequence[str] = ("sine",),
                 dense_factor: int = 4, sine_f0_type: str = "contf0",
                 device="cuda"):
        self.module = module.eval()
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.dense_factor = dense_factor
        self.sine_f0_type = sine_f0_type
        self.signal_generator = SignalGenerator(
            sample_rate, hop_size, sine_amp, noise_amp, signal_types)
        self.to(device)

    def to(self, device) -> "USFGANWrapper":
        self.device = torch.device(device)
        self.module.to(self.device)
        return self

    @torch.no_grad()
    def inference(self, f0: np.ndarray, aux_feats: np.ndarray) -> np.ndarray:
        """f0 (T, 1) Hz, aux_feats (T, aux) -> (T * hop,) float32."""
        x = self.signal_generator(f0)[None]
        d = dilated_factor(f0, self.sample_rate, self.dense_factor)
        d = np.repeat(d, self.hop_size)[None].astype(np.float32)
        c = np.asarray(aux_feats, np.float32)[None]
        dev = self.device
        with conv_precision(dev):
            wav = self.module(*(torch.from_numpy(np.ascontiguousarray(a))
                                .to(dev) for a in (x, c, d)))
        return wav[0, :, 0].cpu().numpy()


class VocoderPack:
    """A generator that takes frame features alone (PWG, HiFiGAN) on
    ``device``: ``inference(c)`` (T', aux) -> (T,) on the host."""

    def __init__(self, module: nn.Module, device="cuda"):
        self.module = module.eval()
        self.to(device)

    def to(self, device) -> "VocoderPack":
        self.device = torch.device(device)
        self.module.to(self.device)
        return self

    @torch.no_grad()
    def inference(self, c: np.ndarray) -> np.ndarray:
        c = torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(
            self.device)
        with conv_precision(self.device):
            return self.module.inference(c[None])[0].cpu().numpy()
