"""Neural-vocoder GAN training, as ``ensemble_svs_with_interactions_tpu/
train/vocoder.py`` runs it: the multi-resolution STFT or log-mel loss, the
hn-uSFGAN residual source loss, LSGAN adversarial terms (and optional
feature matching) and the two-network train step.

The reference behaviour the port copies, on purpose:

* the residual source loss subtracts a CheapTrick envelope whose frame n
  is centred on sample n * hop from ``stft_mag`` frames that start there,
  so at fft 4096 the two are fft / 2 = 2048 samples apart, and the
  shorter of the two framings sets the frame count;
* the spectral convergence is one Frobenius ratio over the whole batch.

Under a process group (``parallel/mesh.py``) every loss is the global
batch's: a mean is each rank's own over the world size (the ranks hold
equal shards), the spectral convergence's norms sum the ranks' squares,
and each network's gradients and the metrics are summed over the ranks in
one all-reduce before clipping, so the NaN-skip decides alike everywhere.

The step runs float32 with cuDNN's TF32 off (``utils/precision.
conv_precision``); nothing in it falls back to the CPU.
"""

from __future__ import annotations

import inspect
from typing import Dict, Sequence

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.data.data_source import (
    mel_filterbank,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.discriminators import (  # noqa: E501
    stft_mag,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    all_reduce_sum_autograd,
    world_size,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import reduce_grads
from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
    conv_precision,
)

METRIC_KEYS = ("Loss_G", "Loss_STFT_SC", "Loss_STFT_Mag", "Loss_Adv",
               "Loss_Source", "Loss_D", "Loss_D_Real", "Loss_D_Fake",
               "GradNorm_G", "GradNorm_D")


def generator_input_arity(generator) -> int:
    """How many tensors the generator's ``forward`` takes: 3 for the
    source-filter families (excitation x, conditioning c, dilation
    factors d), 2 for noise-driven PWG (x, c), 1 for HiFiGAN (c)."""
    params = [p for p in inspect.signature(generator.forward).parameters
              if p not in ("self", "train")]
    if len(params) not in (1, 2, 3):
        raise ValueError(f"unsupported generator signature ({params}); "
                         "expected (x, c, d), (x, c) or (c,)")
    return len(params)


def generator_inputs(batch: Dict, n_args: int):
    """The generator's positional inputs from a vocoder batch."""
    if n_args == 3:
        return (batch["x"], batch["c"], batch["d"])
    if n_args == 2:
        return (batch["x"], batch["c"])
    return (batch["c"],)


def generator_outputs(generator, inputs):
    """What the JAX ``__call__`` returns: ``train_outputs``' tuple where
    the generator has one, else the waveform."""
    if hasattr(generator, "train_outputs"):
        return generator.train_outputs(*inputs)
    return generator(*inputs)


def batch_mean(x):
    """The mean of ``x`` over the global batch: under a process group each
    rank holds an equal shard, so its part is its own mean over the world
    size (the ranks' parts sum to the global mean); ``x.mean()`` without
    one."""
    n = world_size()
    return torch.mean(x) / n if n > 1 else torch.mean(x)


def _frobenius(x, grad: bool = True):
    """||x|| over the global batch: the ranks' sums of squares summed
    (differentiably with ``grad``)."""
    if world_size() == 1:
        return torch.linalg.vector_norm(x)
    sq = (x * x).sum()
    return torch.sqrt(all_reduce_sum_autograd(sq) if grad
                      else all_reduce_sum(sq))


def stft_loss(y_hat, y, fft_sizes: Sequence[int] = (1024, 2048, 512),
              hop_sizes: Sequence[int] = (120, 240, 50),
              win_lengths: Sequence[int] = (600, 1200, 240)):
    """Multi-resolution STFT loss of (B, T) waveforms: (spectral
    convergence, log magnitude L1), each the mean over resolutions."""
    sc_total, mag_total = 0.0, 0.0
    for fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        m_hat = stft_mag(y_hat, fft, hop, win)
        m = stft_mag(y, fft, hop, win)
        sc = (_frobenius(m - m_hat)
              / torch.clamp(_frobenius(m, grad=False), min=1e-6))
        mag = batch_mean(torch.abs(torch.log(m) - torch.log(m_hat)))
        sc_total, mag_total = sc_total + sc, mag_total + mag
    n = len(fft_sizes)
    # each rank carries its part of the global ratio
    return sc_total / n / world_size(), mag_total / n


def mel_spectral_loss(y_hat, y, fb, fft_size: int = 2048,
                      hop_size: int = 512, win_length: int = 2048):
    """L1 between log-mel spectrograms; ``fb`` the (n_mels, bins) float32
    filterbank."""
    m_hat = stft_mag(y_hat, fft_size, hop_size, win_length)
    m = stft_mag(y, fft_size, hop_size, win_length)
    fb = fb.to(m.dtype)
    lm_hat = torch.log(torch.clamp(m_hat @ fb.T, min=1e-7))
    lm = torch.log(torch.clamp(m @ fb.T, min=1e-7))
    return batch_mean(torch.abs(lm_hat - lm))


def residual_source_loss(layer, source, y, f0, fb=None):
    """hn-uSFGAN's source regularization: the generated source's log
    |STFT| pushed toward the target's CheapTrick-whitened residual, log
    |STFT(y)| - log envelope(y) (no gradient), optionally mel-compressed
    by ``fb``; ``layer`` a ``CheapTrickLayer`` at the frame rate of f0
    (B, T'); source and y (B, T)."""
    env = layer(y, f0, elim_0th=True)
    win = layer.fft_size
    s_y = torch.log(torch.clamp(
        stft_mag(y, layer.fft_size, layer.hop_size, win), min=1e-7))
    s_src = torch.log(torch.clamp(
        stft_mag(source, layer.fft_size, layer.hop_size, win), min=1e-7))
    T = min(env.shape[1], s_y.shape[1], s_src.shape[1])
    diff = s_src[:, :T] - (s_y[:, :T] - env[:, :T]).detach()
    if fb is not None:
        diff = diff @ fb.to(diff.dtype).T
    return batch_mean(diff ** 2)


def _flatten_d_outs(outs):
    """A discriminator's list of feature maps, or a list of such lists,
    as a list of lists."""
    if isinstance(outs[0], (list, tuple)):
        return outs
    return [outs]


def mel_fb_tensor(sr: int, fft_size: int, n_mels: int, fmin=0, fmax=None,
                  device="cpu") -> torch.Tensor:
    """``mel_filterbank`` as a float32 tensor on ``device`` (``fmin``
    None is 0)."""
    fb = mel_filterbank(int(sr), int(fft_size), int(n_mels),
                        float(fmin or 0), fmax)
    return torch.from_numpy(fb.astype(np.float32)).to(device)


def _grads(loss, params, retain_graph: bool = False):
    """d loss / d params, zeros for the parameters it does not reach (the
    skip convs, a discriminator whose maps are all empty), so Adam's
    moments for them stay zero as optax's do."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                retain_graph=retain_graph)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _global_norm(grads) -> torch.Tensor:
    """The L2 norm of all of ``grads`` as one vector: one sum of squares,
    the same expression on every device (torch's float32 ``norm`` kernel
    on the CPU drifts on large tensors, 8e-5 of the shipped HiFiGAN
    discriminator's gradient norm, where ``sum`` does not)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    return torch.sqrt((flat * flat).sum())


def _clip(grads, clip_norm: float):
    """Scale ``grads`` in place by min(1, clip / max(|g|, 1e-12)); returns
    (global norm, whether it is finite)."""
    gnorm = _global_norm(grads)
    clip = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, clip)
    return gnorm, torch.isfinite(gnorm)


def _apply(params, grads, optimizer):
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()


def create_vocoder_gan_train_step(
        generator, discriminator, optG, optD, stft_weight: float = 1.0,
        adv_weight: float = 4.0, fm_weight: float = 0.0,
        clip_norm: float = 10.0,
        fft_sizes: Sequence[int] = (1024, 2048, 512),
        hop_sizes: Sequence[int] = (120, 240, 50),
        win_lengths: Sequence[int] = (600, 1200, 240),
        stft_loss_type: str = "multi_resolution", mel_loss_params=None,
        source_weight: float = 0.0, cheaptrick_layer=None,
        source_mel_fb=None, discriminator_train_start_steps: int = 0,
        device="cuda"):
    """The GAN step of the JAX package's ``create_vocoder_gan_train_step``.

    ``generator`` and ``discriminator`` move to ``device``; ``optG`` and
    ``optD`` (``train/loop.build_optimizer``) are built over their
    parameters.  ``train_step(batch)`` takes device tensors x (B, T, S)
    excitation, c (B, T', aux), d (B, T), y (B, T, 1) target audio and,
    for the source loss, f0 (B, T'), and returns ``METRIC_KEYS`` as 0-dim
    tensors on the device.

    * G's loss is taken against the discriminator before this step's
      update, and its backward leaves no gradient in D; D's loss is
      taken on the detached y_hat.  LSGAN terms are means over the
      discriminators.
    * ``stft_loss_type="mel"`` takes the log-mel L1 (``mel_loss_params``;
      SC = Mag = loss / 2 in the metrics); ``source_weight`` > 0 with a
      ``cheaptrick_layer`` adds ``residual_source_loss`` (a
      ``source_mel_fb`` compresses it).
    * Each network's gradients are clipped to ``clip_norm`` on their own;
      a network whose gradient norm is not finite keeps its parameters and
      optimizer state (the one host read a step is these two flags).
    * Before ``discriminator_train_start_steps`` the adversarial and
      feature-matching terms are multiplied by 0, and D's parameters and
      optimizer state stay as they were.

    ``train_step.state["step"]`` counts the calls, as the JAX state's
    ``step``; ``train_step.optimizers`` is (optG, optD)."""
    device = torch.device(device)
    generator.to(device)
    discriminator.to(device)
    mel_params = dict(mel_loss_params or {})
    if stft_loss_type == "mel":
        mel_fb = mel_fb_tensor(mel_params.get("sampling_rate", 48000),
                               mel_params.get("fft_size", 2048),
                               mel_params.get("n_mels", 80),
                               mel_params.get("fmin", 0),
                               mel_params.get("fmax", None), device)
    elif stft_loss_type != "multi_resolution":
        raise ValueError(f"unknown stft_loss_type: {stft_loss_type}")
    if source_mel_fb is not None:
        source_mel_fb = torch.as_tensor(source_mel_fb, dtype=torch.float32,
                                        device=device)
    n_gen_args = generator_input_arity(generator)
    paramsG = list(generator.parameters())
    paramsD = list(discriminator.parameters())
    zero = torch.zeros((), device=device)
    state = {"step": 0}

    def lsgan(outs, target):
        return sum(batch_mean((f[-1] - target) ** 2)
                   for f in outs) / len(outs)

    def g_loss(batch, adv_on: float):
        outs = generator_outputs(generator,
                                 generator_inputs(batch, n_gen_args))
        y_hat = outs[0] if isinstance(outs, tuple) else outs
        y = batch["y"]
        if stft_loss_type == "mel":
            loss_stft = mel_spectral_loss(
                y_hat[..., 0], y[..., 0], mel_fb,
                int(mel_params.get("fft_size", 2048)),
                int(mel_params.get("hop_size", 512)),
                int(mel_params.get("win_length", 2048)))
            sc = mag = loss_stft / 2
        else:
            sc, mag = stft_loss(y_hat[..., 0], y[..., 0], fft_sizes,
                                hop_sizes, win_lengths)
            loss_stft = sc + mag
        loss_source = zero
        if source_weight > 0 and cheaptrick_layer is not None:
            if not (isinstance(outs, tuple) and len(outs) >= 2):
                raise ValueError(
                    "source_weight > 0 requires a source-filter generator "
                    "returning (wav, source, ...)")
            loss_source = residual_source_loss(
                cheaptrick_layer, outs[1][..., 0], y[..., 0], batch["f0"],
                fb=source_mel_fb)
        d_fake = _flatten_d_outs(discriminator(y_hat))
        loss_adv = lsgan(d_fake, 1.0) * adv_on
        loss_fm = zero
        if fm_weight > 0:
            with torch.no_grad():
                d_real = _flatten_d_outs(discriminator(y))
            for fr, fk in zip(d_real, d_fake):
                for r, k in zip(fr[:-1], fk[:-1]):
                    loss_fm = loss_fm + batch_mean(torch.abs(k - r))
            loss_fm = loss_fm * adv_on
        loss = (stft_weight * loss_stft + adv_weight * loss_adv
                + fm_weight * loss_fm + source_weight * loss_source)
        return loss, {"Loss_G": loss, "Loss_STFT_SC": sc,
                      "Loss_STFT_Mag": mag, "Loss_Adv": loss_adv,
                      "Loss_Source": loss_source}, y_hat

    def d_loss(batch, y_hat):
        d_real = _flatten_d_outs(discriminator(batch["y"]))
        d_fake = _flatten_d_outs(discriminator(y_hat))
        loss_real, loss_fake = lsgan(d_real, 1.0), lsgan(d_fake, 0.0)
        loss = loss_real + loss_fake
        return loss, {"Loss_D": loss, "Loss_D_Real": loss_real,
                      "Loss_D_Fake": loss_fake}

    def train_step(batch) -> Dict[str, torch.Tensor]:
        start = discriminator_train_start_steps
        adv_on = 1.0 if start <= 0 else float(state["step"] >= start)
        with conv_precision(device):
            lossG, metrics, y_hat = g_loss(batch, adv_on)
            gradsG = _grads(lossG, paramsG)
            lossD, auxD = d_loss(batch, y_hat.detach())
            gradsD = _grads(lossD, paramsD)
        metrics = reduce_grads(gradsG + gradsD, {**metrics, **auxD})
        gnormG, finiteG = _clip(gradsG, clip_norm)
        gnormD, finiteD = _clip(gradsD, clip_norm)
        okG, okD = torch.stack([finiteG, finiteD]).tolist()
        if okG:
            _apply(paramsG, gradsG, optG)
        if okD and adv_on > 0:
            _apply(paramsD, gradsD, optD)
        state["step"] += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return {**metrics, "GradNorm_G": gnormG, "GradNorm_D": gnormD}

    train_step.state = state
    train_step.optimizers = (optG, optD)
    return train_step
