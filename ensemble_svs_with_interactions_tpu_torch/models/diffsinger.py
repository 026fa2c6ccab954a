"""DiffSinger-style diffusion acoustic models (counterparts in
``ensemble_svs_with_interactions_tpu/models/diffsinger.py``): the beta
schedules, the WaveNet-like denoiser ``DiffNet`` and ``GaussianDiffusion``,
a DDPM over acoustic features with a condition encoder; the FastSpeech2
``FFTBlocksEncoder`` (self-attention blocks over a reversed relative
positional encoding) that the mel-only configs use as that encoder; and
the mel-to-F0 ``PitchPredictor`` and ``PitchExtractor``.

The denoiser's convolutions are ``nn.Conv1d`` on channel-first (B, C, T)
tensors; its submodules carry the flax scope names (``input_proj``,
``mlp_in``, ``mlp_out``, ``res{i}.{step_proj,dilated_conv,cond_proj,
out_proj}``, ``skip_proj``, ``output_proj``), so ``utils/flax_port``
carries the weights both ways.  The JAX package leaves these convolutions
and the samplers' arithmetic to XLA (no Pallas kernel), so they are plain
torch here.  The chain runs in float32: cuDNN's TF32 is held off around
it (``utils/precision.conv_precision``) unless ``allow_tf32`` is set on
the module.

The noise schedule's tables are computed in float64 and cast to float32,
as the JAX package does.  The samplers draw their noise (x_T, and for
the ancestral sampler one draw per step) from the ``chain_generator``
they are given, on that generator's device; tests replay another run's
noise through :func:`chain_noise`.

The attention, its FFN and the pitch models' convolutions are plain
torch ops, as the JAX package leaves them to XLA.  Their submodules carry
the flax scope names (``_FFTBlock_{i}.{norm_1,in_proj,out_proj,norm_2,
ffn_1,ffn_2}``, ``fc``, ``Conv_{i}``, ``LayerNorm_{i}``, ``Dense_{i}``)
and ``FFTBlocksEncoder`` its ``pos_embed_alpha`` as a parameter of that
name (``FLAX_LEAVES``), so ``utils/flax_port`` carries the weights both
ways.  In training the FFT blocks drop attention weights and FFN
activations at 0.1 whatever the config's ``dropout``, as the JAX blocks
do.

``MultiSpeakerGaussianDiffusion`` conditions the encoder on a speaker
table; an FFT encoder takes the embeddings through its ``spk_fc``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models import layers
from ensemble_svs_with_interactions_tpu_torch.models.generic import (
    condition_on_speakers,
    speaker_embeddings,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import shard_draw
from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
    conv_precision,
)


def linear_beta_schedule(timesteps: int, min_beta=1e-4, max_beta=0.06):
    return np.linspace(min_beta, max_beta, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008):
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 0, 0.999)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``SinusoidalPosEmb``: (B,) steps -> (B, dim) [sin | cos]."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                    * -emb)
    emb = t[:, None].to(torch.float32) * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def _promoted(layer, x):
    """``layer(x)`` for a ``nn.Linear`` or ``nn.Conv1d``, with ``x`` and
    the weights promoted to their common dtype where they differ, as
    flax's Dense and Conv promote them: in the AMP arm the noise
    schedule's float32 tables lift the noised features (and the step
    embedding is float32) while the weights are bf16, so the denoiser
    runs in float32 as the JAX step's does."""
    w = layer.weight
    if x.dtype == w.dtype:
        return layer(x)
    dt = torch.promote_types(x.dtype, w.dtype)
    b = None if layer.bias is None else layer.bias.to(dt)
    if isinstance(layer, nn.Linear):
        return F.linear(x.to(dt), w.to(dt), b)
    return F.conv1d(x.to(dt), w.to(dt), b, layer.stride, layer.padding,
                    layer.dilation, layer.groups)


class _DiffResidualBlock(nn.Module):
    """Gated dilated-conv residual block on (B, C, T)."""

    def __init__(self, residual_channels: int, encoder_hidden_dim: int,
                 dilation: int):
        super().__init__()
        C = residual_channels
        self.step_proj = nn.Linear(C, C)
        self.dilated_conv = nn.Conv1d(C, 2 * C, 3, dilation=dilation,
                                      padding=dilation)
        self.cond_proj = nn.Conv1d(encoder_hidden_dim, 2 * C, 1)
        self.out_proj = nn.Conv1d(C, 2 * C, 1)

    def forward(self, x, cond, step_emb):
        h = x + _promoted(self.step_proj, step_emb)[:, :, None]
        h = _promoted(self.dilated_conv, h) + _promoted(self.cond_proj, cond)
        gate, filt = h.chunk(2, dim=1)
        h = _promoted(self.out_proj, torch.sigmoid(gate) * torch.tanh(filt))
        residual, skip = h.chunk(2, dim=1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffNet(nn.Module):
    """The WaveNet-like denoiser.  ``forward`` takes the JAX package's
    feature-last layout; ``denoise`` is the channel-first core the samplers
    call.  torch's initial ``output_proj`` is random where flax's is zero;
    a pack's weights replace both."""

    def __init__(self, in_dim: int = 80, encoder_hidden_dim: int = 256,
                 residual_layers: int = 20, residual_channels: int = 256,
                 dilation_cycle_length: int = 4):
        super().__init__()
        C = residual_channels
        self.residual_channels = C
        self.residual_layers = residual_layers
        self.input_proj = nn.Conv1d(in_dim, C, 1)
        self.mlp_in = nn.Linear(C, 4 * C)
        self.mlp_out = nn.Linear(4 * C, C)
        for i in range(residual_layers):
            setattr(self, f"res{i}", _DiffResidualBlock(
                C, encoder_hidden_dim, 2 ** (i % dilation_cycle_length)))
        self.skip_proj = nn.Conv1d(C, C, 1)
        self.output_proj = nn.Conv1d(C, in_dim, 1)

    def denoise(self, x, diffusion_step, cond):
        """x (B, M, T), diffusion_step (B,), cond (B, E, T) -> (B, M, T)."""
        x = F.relu(_promoted(self.input_proj, x))
        h = _promoted(self.mlp_in, sinusoidal_pos_emb(
            diffusion_step, self.residual_channels))
        emb = _promoted(self.mlp_out, h * torch.tanh(F.softplus(h)))  # Mish
        skips = 0
        for i in range(self.residual_layers):
            x, skip = getattr(self, f"res{i}")(x, cond, emb)
            skips = skips + skip
        x = F.relu(_promoted(self.skip_proj,
                             skips / math.sqrt(self.residual_layers)))
        return _promoted(self.output_proj, x)

    def forward(self, spec, diffusion_step, cond):
        """spec (B, T, M), diffusion_step (B,), cond (B, T, E) ->
        (B, T, M)."""
        return self.denoise(spec.transpose(1, 2), diffusion_step,
                            cond.transpose(1, 2)).transpose(1, 2)


# --------------------------------------------------------------- the noise
# the open chain_noise block of this thread or task: {"draws", "record"}
_CHAIN: contextvars.ContextVar = contextvars.ContextVar("chain_noise",
                                                        default=None)


@contextlib.contextmanager
def chain_noise(draws: Optional[List[Dict]] = None):
    """Within the block every ``GaussianDiffusion`` and ``FlowMatching``
    call takes its noise
    from ``draws``, one entry per call in call order, or, with ``draws``
    None, records the noise it draws into the list it yields.  Inference
    entries are ``{"x_T": (B, T, M), "steps": (K, B, T, M) or None}``
    (``steps``: the ancestral sampler's per-step draws, step i at t = K -
    1 - i; ``None`` for the other samplers and ``FlowMatching``);
    training entries ``{"t": (B,), "noise": (B, T, M)}`` (``t`` integer
    steps for ``GaussianDiffusion``, times in [0, 1) for
    ``FlowMatching``, whose ``noise`` is its x0).  Tests
    replay the JAX package's chains, and the card's on the CPU, through
    it."""
    if _CHAIN.get() is not None:
        raise RuntimeError("chain_noise blocks do not nest")
    record = draws is None
    block = {"draws": [] if record else list(draws), "record": record}
    token = _CHAIN.set(block)
    try:
        yield block["draws"]
    finally:
        _CHAIN.reset(token)


def _replayed():
    """The next entry to replay, or None (no block, or a recording one)."""
    block = _CHAIN.get()
    if block is None or block["record"]:
        return None
    if not block["draws"]:
        raise RuntimeError("chain_noise: more GaussianDiffusion calls than "
                           "entries")
    return block["draws"].pop(0)


def _recording() -> bool:
    block = _CHAIN.get()
    return block is not None and block["record"]


def _record(entry: Dict):
    if _recording():
        _CHAIN.get()["draws"].append(
            {k: None if v is None else v.detach().cpu().clone()
             for k, v in entry.items()})


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _normal(shape, generator, device):
    if generator is None:
        raise ValueError("the diffusion and flow-matching decoders draw "
                         "their noise from a torch.Generator: pass "
                         "chain_generator")
    return shard_draw(lambda s: torch.randn(s, generator=generator,
                                            device=generator.device),
                      shape, 0).to(device)


class GaussianDiffusion(BaseModel):
    """DDPM over acoustic features (B, T, out_dim) with an optional
    condition encoder.  Training (``forward`` with ``y``) returns ``(noise,
    x_recon)``, the ``DIFFUSION`` contract of ``multistream_loss``;
    ``inference`` runs the sampler the config names: ``ancestral`` (the
    default), ``plms`` (``pndm_speedup`` implies it), ``ddim`` or
    ``dpmpp``.  ``allow_tf32`` (an attribute, not a config key, False by
    default) lets cuDNN take TF32 in the chain."""

    def __init__(self, in_dim: int, out_dim: int, denoise_fn: nn.Module,
                 encoder: Optional[nn.Module] = None, K_step: int = 100,
                 schedule_type: str = "linear", betas: Any = None,
                 scheduler_params: Any = None, norm_scale: float = 10.0,
                 pndm_speedup: Optional[int] = None,
                 sampler: Optional[str] = None,
                 sampling_steps: Optional[int] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.denoise_fn = denoise_fn
        self.encoder = encoder
        self.K_step = K_step
        self.norm_scale = norm_scale
        self.pndm_speedup = pndm_speedup
        self.sampler = sampler or ("plms" if pndm_speedup else "ancestral")
        if self.sampler not in ("ancestral", "plms", "ddim", "dpmpp"):
            raise ValueError(f"unknown sampler: {sampler}")
        self.sampling_steps = sampling_steps
        self.allow_tf32 = False
        if betas is not None:
            # a schedule longer than K_step walks its first K_step betas
            betas = np.asarray(betas, np.float64)
            assert len(betas) >= K_step
            betas = betas[:K_step]
        else:
            params = dict(scheduler_params or {})
            if schedule_type == "linear":
                betas = linear_beta_schedule(K_step, **params)
            else:
                betas = cosine_beta_schedule(K_step, **params)
        ac = np.cumprod(1.0 - betas)
        prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - prev) / (1.0 - ac)
        f32 = {
            "betas": betas, "ac": ac, "sqrt_ac": np.sqrt(ac),
            "sqrt_1mac": np.sqrt(1 - ac), "sqrt_recip_ac": np.sqrt(1 / ac),
            "sqrt_recipm1_ac": np.sqrt(1 / ac - 1),
            "post_log_var": np.log(np.maximum(post_var, 1e-20)),
            "post_c1": betas * np.sqrt(prev) / (1.0 - ac),
            "post_c2": (1.0 - prev) * np.sqrt(1.0 - betas) / (1.0 - ac),
        }
        # float32 host tables, indexed by a Python step in the samplers
        self.tables = {k: np.asarray(v, np.float32) for k, v in f32.items()}

    def prediction_type(self):
        return PredictionType.DIFFUSION

    def _cond(self, cond, lengths, spk_embs, train, generator):
        if self.encoder is None:
            return cond
        kw = {"train": train}
        if train:
            kw["generator"] = generator
        if spk_embs is not None:
            kw["spk_embs"] = spk_embs
        return self.encoder(cond, lengths, **kw)

    def forward(self, cond, lengths=None, y=None, spk_embs=None,
                train: bool = False, generator=None):
        """The training forward: t uniform in [0, K_step) and standard
        normal noise from ``generator`` (which also draws the encoder's
        dropout); returns ``(noise, x_recon)``, (B, T, out_dim) each."""
        B = cond.shape[0]
        cond = self._cond(cond, lengths, spk_embs, train, generator)
        x0 = y / self.norm_scale
        entry = _replayed()
        if entry is None:
            if generator is None:
                raise ValueError("the diffusion training forward draws t "
                                 "and its noise from a torch.Generator")
            t = torch.randint(0, self.K_step, (B,), generator=generator,
                              device=generator.device).to(x0.device)
            # in x0's dtype, as JAX draws it (bf16 in the AMP arm)
            noise = _normal(x0.shape, generator, x0.device).to(x0.dtype)
            _record({"t": t, "noise": noise})
        else:
            t = _tensor(entry["t"]).to(x0.device, torch.int64)
            noise = _tensor(entry["noise"]).to(x0)
        sqrt_ac = torch.from_numpy(self.tables["sqrt_ac"]).to(x0.device)
        sqrt_1mac = torch.from_numpy(self.tables["sqrt_1mac"]).to(x0.device)
        x_noisy = (sqrt_ac[t][:, None, None] * x0
                   + sqrt_1mac[t][:, None, None] * noise)
        with conv_precision(x0.device, self.allow_tf32):
            x_recon = self.denoise_fn(x_noisy, t, cond)
        return noise, x_recon

    @torch.no_grad()
    def inference(self, cond, lengths=None, spk_embs=None,
                  chain_generator=None):
        """Sample (B, T, out_dim) features conditioned on ``cond`` (B, T,
        in_dim): x_T and the ancestral sampler's per-step noise from
        ``chain_generator`` (or a :func:`chain_noise` block)."""
        B, T = cond.shape[0], cond.shape[1]
        cond = self._cond(cond, lengths, spk_embs, False, None)
        shape = (B, T, self.out_dim)
        entry = _replayed()
        if entry is None:
            x = _normal(shape, chain_generator, cond.device)
            steps = None
            if self.sampler == "ancestral":
                # drawn step by step, unless they are recorded
                steps = (_normal(shape, chain_generator, cond.device)
                         for _ in range(self.K_step))
                if _recording():
                    steps = torch.stack(list(steps))
            _record({"x_T": x, "steps": steps})
        else:
            x = _tensor(entry["x_T"]).to(cond)
            steps = entry.get("steps")
            if steps is not None:
                steps = _tensor(steps).to(cond)
        cond = cond.transpose(1, 2).contiguous()
        x = x.transpose(1, 2).contiguous()
        with conv_precision(cond.device, self.allow_tf32):
            if self.sampler == "plms":
                x = self._plms_sample(x, cond)
            elif self.sampler == "ddim":
                x = self._ddim_sample(x, cond)
            elif self.sampler == "dpmpp":
                x = self._dpmpp_sample(x, cond)
            else:
                x = self._ancestral_sample(x, cond, steps)
        return x.transpose(1, 2) * self.norm_scale

    # ------------------------------------------------------------ samplers
    # Each takes and returns the channel-first (B, M, T) state; cond is
    # the encoded condition (B, E, T); noise draws are (B, T, M).
    def _eps(self, x, t: int, cond):
        tb = torch.full((x.shape[0],), int(t), dtype=torch.int64,
                        device=x.device)
        return self.denoise_fn.denoise(x, tb, cond)

    def _ancestral_sample(self, x, cond, steps):
        """K_step posterior steps from t = K_step - 1 down to 0; x_recon
        clipped to [-1, 1]; no noise at t = 0.  ``steps`` yields one (B,
        T, M) draw per step."""
        tab = self.tables
        for t, noise in zip(range(self.K_step - 1, -1, -1), steps):
            eps = self._eps(x, t, cond)
            x_recon = (float(tab["sqrt_recip_ac"][t]) * x
                       - float(tab["sqrt_recipm1_ac"][t]) * eps)
            x_recon = x_recon.clamp(-1.0, 1.0)
            mean = (float(tab["post_c1"][t]) * x_recon
                    + float(tab["post_c2"][t]) * x)
            if t > 0:
                sigma = float(np.exp(np.float32(0.5) * tab["post_log_var"][t]))
                mean = mean + sigma * noise.transpose(1, 2)
            x = mean
        return x

    def _sampling_grid(self):
        """Descending grid of ``sampling_steps`` timesteps ending at t = 0
        (K_step // 10 by default; one point is the single jump from
        K_step - 1)."""
        n = int(self.sampling_steps or max(self.K_step // 10, 1))
        n = max(1, min(n, self.K_step))
        return np.unique(np.round(np.linspace(self.K_step - 1, 0, n))
                         .astype(np.int64))[::-1]

    def _ddim_sample(self, x, cond):
        """DDIM (eta = 0) on the sampling grid; the last step lands on the
        clean state (alpha = 1)."""
        ts = self._sampling_grid()
        ac = self.tables["ac"]
        a_s = np.append(ac[ts[1:]], np.float32(1.0))
        for t, at, as_ in zip(ts, ac[ts], a_s):
            eps = self._eps(x, t, cond)
            x0 = ((x - float(np.sqrt(np.float32(1.0) - at)) * eps)
                  / float(np.sqrt(at))).clamp(-1.0, 1.0)
            x = (float(np.sqrt(as_)) * x0
                 + float(np.sqrt(np.float32(1.0) - as_)) * eps)
        return x

    def _dpmpp_sample(self, x, cond):
        """DPM-Solver++(2M) on the sampling grid (data prediction,
        multistep in lambda = log(alpha / sigma)); the last step is first
        order and lands on the x0 prediction."""
        ts = self._sampling_grid()
        ac = np.asarray(self.tables["ac"], np.float64)[ts]
        alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
        lam = np.log(alpha / np.maximum(sigma, 1e-20))
        n = len(ts)
        f32 = np.float32
        h = np.append(lam[1:] - lam[:-1], 1.0).astype(f32)
        a_next = np.append(alpha[1:], 1.0).astype(f32)
        s_next = np.append(sigma[1:], 0.0).astype(f32)
        ac, sigma = ac.astype(f32), sigma.astype(f32)
        x0_prev, h_prev = torch.zeros_like(x), f32(1e30)
        for i, t in enumerate(ts):
            eps = self._eps(x, t, cond)
            x0 = ((x - float(sigma[i]) * eps)
                  / float(np.sqrt(ac[i]))).clamp(-1.0, 1.0)
            final = i == n - 1
            coeff = f32(0.0) if final else h[i] / (f32(2.0) * h_prev)
            D = float(f32(1.0) + coeff) * x0 - float(coeff) * x0_prev
            if final:
                x = D
            else:
                x = (float(s_next[i] / np.maximum(sigma[i], f32(1e-20))) * x
                     - float(a_next[i] * np.expm1(-h[i])) * D)
            x0_prev, h_prev = x0, h[i]
        return x

    def _plms_sample(self, x, cond):
        """PLMS: a Heun first step (two denoiser calls), then
        Adams-Bashforth of order 2-4 over the noise history, every
        ``pndm_speedup`` steps."""
        interval = int(self.pndm_speedup)
        ts = list(range(self.K_step - interval, -1, -interval))
        if not ts:
            return x
        ac = self.tables["ac"]
        f32 = np.float32

        def x_pred(x, noise_t, t):
            a_t, a_prev = ac[t], ac[max(t - interval, 0)]
            sq_t, sq_prev = np.sqrt(a_t), np.sqrt(a_prev)
            den_x = float(sq_t * (sq_t + sq_prev))
            den_n = float(sq_t * (np.sqrt((f32(1.0) - a_prev) * a_t)
                                  + np.sqrt((f32(1.0) - a_t) * a_prev)))
            return x + float(a_prev - a_t) * (x / den_x - noise_t / den_n)

        t0 = ts[0]
        eps0 = self._eps(x, t0, cond)
        first = x_pred(x, eps0, t0)
        eps_prev = self._eps(first, max(t0 - interval, 0), cond)
        x = x_pred(x, (eps0 + eps_prev) / 2, t0)
        hist = [eps0]
        for t in ts[1:]:
            eps = self._eps(x, t, cond)
            if len(hist) == 1:
                eps_prime = (3 * eps - hist[0]) / 2
            elif len(hist) == 2:
                eps_prime = (23 * eps - 16 * hist[0] + 5 * hist[1]) / 12
            else:
                eps_prime = (55 * eps - 59 * hist[0] + 37 * hist[1]
                             - 9 * hist[2]) / 24
            x = x_pred(x, eps_prime, t)
            hist = [eps] + hist[:2]
        return x


def rel_positional_encoding(T: int, d: int, max_len: int = 5000,
                            device=None) -> torch.Tensor:
    """(1, T, d) float32 [sin | cos] table over REVERSED positions, as
    the JAX package builds it: the table spans ``max(max_len, T)``
    positions and its first T rows are taken, so positions run
    ``L - 1`` down to ``L - T``."""
    L = max(max_len, T)
    position = torch.arange(L - 1, L - 1 - T, -1, dtype=torch.float32,
                            device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((T, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe[None]


def _drop(x, p, train: bool, generator):
    return layers.dropout(x, p, generator) if train else x


class _FFTBlock(nn.Module):
    """Pre-norm self-attention (a combined bias-free qkv projection, keys
    past each row's length masked) and a pre-norm conv FFN (conv, scaled
    by ``kernel_size ** -0.5``, exact GELU, linear); the state is
    re-masked after each residual."""

    def __init__(self, hidden_dim: int, num_heads: int, kernel_size: int,
                 dropout: float, attention_dropout: float = 0.1,
                 relu_dropout: float = 0.1):
        super().__init__()
        E = hidden_dim
        self.num_heads, self.kernel_size = num_heads, kernel_size
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.relu_dropout = relu_dropout
        self.norm_1 = nn.LayerNorm(E, eps=1e-5)
        self.in_proj = nn.Linear(E, 3 * E, bias=False)
        self.out_proj = nn.Linear(E, E, bias=False)
        self.norm_2 = nn.LayerNorm(E, eps=1e-5)
        self.ffn_1 = nn.Conv1d(E, 4 * E, kernel_size,
                               padding=kernel_size // 2)
        self.ffn_2 = nn.Linear(4 * E, E)

    def forward(self, x, mask, train: bool = False, generator=None):
        """x (B, T, E), mask (B, T) bool -> (B, T, E)."""
        B, T, E = x.shape
        H = self.num_heads
        dk = E // H
        fmask = mask[:, :, None].to(x.dtype)
        q, k, v = self.in_proj(self.norm_1(x)).chunk(3, dim=-1)
        q = q.reshape(B, T, H, dk).transpose(1, 2) * (dk ** -0.5)
        k = k.reshape(B, T, H, dk).transpose(1, 2)
        v = v.reshape(B, T, H, dk).transpose(1, 2)
        scores = torch.where(mask[:, None, None, :], q @ k.transpose(-1, -2),
                             torch.full((), -1e9, dtype=x.dtype,
                                        device=x.device))
        p = _drop(torch.softmax(scores, dim=-1), self.attention_dropout,
                  train, generator)
        out = self.out_proj((p @ v).transpose(1, 2).reshape(B, T, E))
        x = (x + _drop(out, self.dropout, train, generator)) * fmask
        h = self.ffn_1(self.norm_2(x).transpose(1, 2)).transpose(1, 2)
        h = F.gelu(h * (self.kernel_size ** -0.5))
        h = self.ffn_2(_drop(h, self.relu_dropout, train, generator))
        return (x + _drop(h, self.dropout, train, generator)) * fmask


class FFTBlocksEncoder(BaseModel):
    """FastSpeech2 FFT-block encoder: an optional phoneme-context
    embedding, an optional reduction by ``reduction_factor`` (a depthwise
    strided conv, or every r-th frame), ``fc``, the reversed positional
    encoding scaled by a learnable ``pos_embed_alpha``, ``num_layers``
    ``_FFTBlock``s, an optional last LayerNorm and, unless ``out_dim`` is
    None (a condition encoder's hidden states), ``fc_out`` back to r
    frames of ``out_dim``.  ``ffn_kernel_size`` overrides ``kernel_size``;
    only LayerNorm blocks (``norm="ln"``) exist."""

    FLAX_LEAVES = ("pos_embed_alpha",)

    def __init__(self, in_dim: int, hidden_dim: int = 256,
                 out_dim: Optional[int] = None, num_layers: int = 4,
                 num_heads: int = 2, kernel_size: int = 9,
                 ffn_kernel_size: Optional[int] = None, norm: str = "ln",
                 dropout: float = 0.1, use_pos_embed: bool = True,
                 use_last_norm: bool = True,
                 use_pos_embed_alpha: bool = True,
                 reduction_factor: int = 1, downsample_by_conv: bool = True,
                 in_ph_start_idx: int = 1, in_ph_end_idx: int = 50,
                 embed_dim: Optional[int] = None):
        super().__init__()
        if norm != "ln":
            raise ValueError("only LayerNorm FFT blocks are supported")
        self.hidden_dim, self.out_dim = hidden_dim, out_dim
        self.dropout = dropout
        self.use_pos_embed = use_pos_embed
        self.use_last_norm = use_last_norm
        self.reduction_factor = r = reduction_factor
        self.downsample_by_conv = downsample_by_conv
        width = in_dim
        self.PhonemeContextEmbedding_0 = None
        if embed_dim is not None:
            self.PhonemeContextEmbedding_0 = layers.PhonemeContextEmbedding(
                in_dim, embed_dim, in_ph_start_idx, in_ph_end_idx)
            width = embed_dim
        self.Conv_0 = (nn.Conv1d(width, width, r, stride=r, groups=width)
                       if r > 1 and downsample_by_conv else None)
        self.fc = nn.Linear(width, hidden_dim)
        self.spk_fc = None
        self.pos_embed_alpha = (nn.Parameter(torch.ones(1))
                                if use_pos_embed and use_pos_embed_alpha
                                else None)
        self.num_layers = num_layers
        k = ffn_kernel_size if ffn_kernel_size is not None else kernel_size
        for i in range(num_layers):
            setattr(self, f"_FFTBlock_{i}",
                    _FFTBlock(hidden_dim, num_heads, k, dropout))
        self.layer_norm = (nn.LayerNorm(hidden_dim, eps=1e-5)
                           if use_last_norm else None)
        self.fc_out = (nn.Linear(hidden_dim, out_dim * r)
                       if out_dim is not None else None)

    def add_speaker_input(self, dim: int):
        """Take speaker embeddings of width ``dim`` through ``spk_fc``
        (which the multi-speaker models that hold this encoder add)."""
        self.spk_fc = nn.Linear(dim, self.hidden_dim)

    def forward(self, x, lengths=None, y=None, spk_embs=None,
                train: bool = False, generator=None):
        """x (B, T, in_dim) -> hidden states (B, T // r, hidden_dim), or
        (B, T // r * r, out_dim) with ``out_dim``.  Speaker embeddings
        ``spk_embs`` (B, T, E), every r-th frame of them, are added through
        ``spk_fc`` after ``fc``.  Dropout masks in training come from
        ``generator``."""
        if spk_embs is not None and self.spk_fc is None:
            raise ValueError("this FFTBlocksEncoder takes no speaker "
                             "embeddings: add_speaker_input() gives it "
                             "spk_fc")
        B, T = x.shape[0], x.shape[1]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int64, device=x.device)
        lengths = torch.as_tensor(lengths, device=x.device)
        if self.PhonemeContextEmbedding_0 is not None:
            x = self.PhonemeContextEmbedding_0(x)
        r = self.reduction_factor
        if r > 1:
            lengths = lengths // r
            if self.Conv_0 is not None:
                x = self.Conv_0(x.transpose(1, 2)).transpose(1, 2)
            else:
                x = x[:, r - 1:: r]
            if spk_embs is not None:
                spk_embs = spk_embs[:, r - 1:: r][:, :x.shape[1]]
        h = self.fc(x)
        if spk_embs is not None:
            h = h + self.spk_fc(spk_embs)
        T2 = h.shape[1]
        mask = (torch.arange(T2, device=x.device)[None, :]
                < lengths[:, None])
        fmask = mask[:, :, None].to(h.dtype)
        if self.use_pos_embed:
            pe = rel_positional_encoding(T2, self.hidden_dim,
                                         device=x.device).to(h.dtype)
            alpha = (self.pos_embed_alpha if self.pos_embed_alpha is not None
                     else 1.0)
            h = h + alpha * (h * math.sqrt(self.hidden_dim) + pe)
            h = _drop(h, self.dropout, train, generator)
        h = h * fmask
        for i in range(self.num_layers):
            h = getattr(self, f"_FFTBlock_{i}")(h, mask, train, generator)
        if self.layer_norm is not None:
            h = self.layer_norm(h) * fmask
        if self.fc_out is None:
            return h
        return self.fc_out(h).reshape(B, -1, self.out_dim)

    def inference(self, x, lengths=None):
        return self(x, lengths)


def _conv_ln_relu_stack(model, h, first: int, n: int, train: bool,
                        generator, drop: bool = True):
    """Layers ``first`` .. ``first + n - 1`` of ``Conv_i`` ("SAME") ->
    ReLU -> ``LayerNorm_i`` (eps 1e-5), each followed by dropout in
    training where ``drop``."""
    for i in range(first, first + n):
        conv = getattr(model, f"Conv_{i}")
        h = torch.relu(conv(h.transpose(1, 2)).transpose(1, 2))
        h = getattr(model, f"LayerNorm_{i}")(h)
        if drop:
            h = _drop(h, model.dropout, train, generator)
    return h


def _add_conv_ln(model, first: int, n: int, in_dim: int, hidden_dim: int,
                 kernel_size: int):
    for i in range(first, first + n):
        setattr(model, f"Conv_{i}",
                nn.Conv1d(in_dim if i == first else hidden_dim, hidden_dim,
                          kernel_size, padding="same"))
        setattr(model, f"LayerNorm_{i}", nn.LayerNorm(hidden_dim, eps=1e-5))


class PitchPredictor(BaseModel):
    """Conv stack over mel frames -> (lf0, V/UV logit): ``num_layers`` x
    (conv, ReLU, LayerNorm, dropout), then ``Dense_0`` and ``Dense_1``.
    ``inference`` gives [lf0 | sigmoid(V/UV)]."""

    def __init__(self, in_dim: int = 80, hidden_dim: int = 256,
                 num_layers: int = 5, kernel_size: int = 5,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        _add_conv_ln(self, 0, num_layers, in_dim, hidden_dim, kernel_size)
        self.Dense_0 = nn.Linear(hidden_dim, 1)
        self.Dense_1 = nn.Linear(hidden_dim, 1)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = _conv_ln_relu_stack(self, x, 0, self.num_layers, train,
                                generator)
        return self.Dense_0(h), self.Dense_1(h)

    def inference(self, x, lengths=None):
        lf0, vuv = self(x, lengths)
        return torch.cat([lf0, torch.sigmoid(vuv)], dim=-1)


class PitchExtractor(BaseModel):
    """Mel -> F0: a conv prenet (``prenet_layers`` x conv, ReLU,
    LayerNorm) and ``Dense_0``, a residual conv encoder (``conv_layers``
    x conv, ReLU, LayerNorm, dropout, + input), then a
    ``PitchPredictor``.  The head predicts log2 F0; ``inference`` gives the
    natural-log lf0, 0 where the V/UV logit is positive."""

    def __init__(self, in_dim: int = 80, hidden_dim: int = 256,
                 prenet_layers: int = 3, conv_layers: int = 2,
                 predictor_layers: int = 5, kernel_size: int = 5,
                 dropout: float = 0.1):
        super().__init__()
        self.prenet_layers, self.conv_layers = prenet_layers, conv_layers
        self.dropout = dropout
        _add_conv_ln(self, 0, prenet_layers, in_dim, hidden_dim, kernel_size)
        self.Dense_0 = nn.Linear(hidden_dim, hidden_dim)
        for i in range(prenet_layers, prenet_layers + conv_layers):
            _add_conv_ln(self, i, 1, hidden_dim, hidden_dim, kernel_size)
        self.PitchPredictor_0 = PitchPredictor(
            hidden_dim, hidden_dim, predictor_layers, kernel_size, dropout)

    def forward(self, x, lengths=None, y=None, train: bool = False,
                generator=None):
        h = _conv_ln_relu_stack(self, x, 0, self.prenet_layers, train,
                                generator, drop=False)
        h = self.Dense_0(h)
        for i in range(self.prenet_layers,
                       self.prenet_layers + self.conv_layers):
            h = _conv_ln_relu_stack(self, h, i, 1, train, generator) + h
        return self.PitchPredictor_0(h, lengths, train=train,
                                     generator=generator)

    def inference(self, x, lengths=None):
        lf0, vuv = self(x, lengths)
        return torch.where(vuv <= 0, lf0 * math.log(2.0),
                           torch.zeros((), dtype=lf0.dtype,
                                       device=lf0.device))


class MultiSpeakerGaussianDiffusion(GaussianDiffusion):
    """``GaussianDiffusion`` with a speaker table
    (``speaker_embedding``): the embeddings of ``spks``, broadcast over
    time, go to the condition encoder (through its ``spk_fc`` where it is
    an FFT encoder); without an encoder they reach nothing, as in the JAX
    model."""

    def __init__(self, *args, speaker_embedding: Any = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.speaker_embedding = speaker_embedding
        condition_on_speakers(speaker_embedding, self.encoder)

    def _spk_embs(self, spks, cond):
        return speaker_embeddings(self.speaker_embedding, spks,
                                  cond.shape[0], cond.shape[1])

    def forward(self, cond, spks, lengths=None, y=None, train: bool = False,
                generator=None):
        return super().forward(cond, lengths, y,
                               spk_embs=self._spk_embs(spks, cond),
                               train=train, generator=generator)

    @torch.no_grad()
    def inference(self, cond, spks, lengths=None, chain_generator=None):
        return super().inference(cond, lengths,
                                 spk_embs=self._spk_embs(spks, cond),
                                 chain_generator=chain_generator)
