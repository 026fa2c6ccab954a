"""DiffSinger-style diffusion acoustic models (counterparts in
``ensemble_svs_with_interactions_tpu/models/diffsinger.py``): the beta
schedules, the WaveNet-like denoiser ``DiffNet`` and ``GaussianDiffusion``,
a DDPM over acoustic features with a condition encoder.

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

Not ported: ``MultiSpeakerGaussianDiffusion``, ``FFTBlocksEncoder``,
``PitchPredictor`` and ``PitchExtractor``.  A config naming one raises
``NotImplementedError`` naming its JAX module.
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
        h = x + self.step_proj(step_emb)[:, :, None]
        h = self.dilated_conv(h) + self.cond_proj(cond)
        gate, filt = h.chunk(2, dim=1)
        h = self.out_proj(torch.sigmoid(gate) * torch.tanh(filt))
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
        x = F.relu(self.input_proj(x))
        h = self.mlp_in(sinusoidal_pos_emb(diffusion_step,
                                           self.residual_channels))
        emb = self.mlp_out(h * torch.tanh(F.softplus(h)))  # Mish
        skips = 0
        for i in range(self.residual_layers):
            x, skip = getattr(self, f"res{i}")(x, cond, emb)
            skips = skips + skip
        x = F.relu(self.skip_proj(skips / math.sqrt(self.residual_layers)))
        return self.output_proj(x)

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
    """Within the block every ``GaussianDiffusion`` call takes its noise
    from ``draws``, one entry per call in call order, or, with ``draws``
    None, records the noise it draws into the list it yields.  Inference
    entries are ``{"x_T": (B, T, M), "steps": (K, B, T, M) or None}``
    (``steps``: the ancestral sampler's per-step draws, step i at t = K -
    1 - i); training entries ``{"t": (B,), "noise": (B, T, M)}``.  Tests
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
        raise ValueError("GaussianDiffusion draws its noise from a "
                         "torch.Generator: pass chain_generator")
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


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
            noise = _normal(x0.shape, generator, x0.device)
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


def _unported(name: str):
    """A ``_target_`` the port does not have: building it raises
    ``NotImplementedError`` naming the JAX module."""
    def refuse(*args, **kwargs):
        from ensemble_svs_with_interactions_tpu_torch.gen import unported

        raise unported(name, name)

    refuse.__name__ = refuse.__qualname__ = name
    return refuse


MultiSpeakerGaussianDiffusion = _unported("MultiSpeakerGaussianDiffusion")
FFTBlocksEncoder = _unported("FFTBlocksEncoder")
PitchPredictor = _unported("PitchPredictor")
PitchExtractor = _unported("PitchExtractor")
