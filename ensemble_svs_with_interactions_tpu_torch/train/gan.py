"""GAN training of the learned postfilters, as ``ensemble_svs_with_
interactions_tpu/train/gan.py`` runs it: one step updates the postfilter
(G) from reconstruction, adversarial and feature-matching losses, then the
discriminator (D) on the same step's G output.

The reference behaviour the port copies, on purpose: a discriminator map
is masked over the padded frames only where its time axis is the batch's
(``_d_mean``); the strided maps, and every map of a discriminator with
``padding: [0, 0]``, are plain means over padded frames too.  A map that
an input too short for the kernels leaves empty has a NaN mean, as in
JAX, and adds nothing to the gradients.

Under a process group the losses are the global batch's and the
gradients are summed over the ranks before clipping, as in
``train/vocoder.py``.

The convolutions run float32 with cuDNN's TF32 off (``utils/precision.
conv_precision``); nothing in the step falls back to the CPU.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    select_streams,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import amp_forward
from ensemble_svs_with_interactions_tpu_torch.train.losses import masked_mean
from ensemble_svs_with_interactions_tpu_torch.train.vocoder import (
    _apply,
    _clip,
    _grads,
    batch_mean,
    reduce_grads,
)
from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
    conv_precision,
)

METRIC_KEYS = ("Loss_G", "Loss_Recon", "Loss_Adv", "Loss_FM", "Loss_D",
               "Loss_D_Real", "Loss_D_Fake", "GradNorm_G", "GradNorm_D")
GAN_TYPES = ("lsgan", "vanilla-gan", "hinge")
_EPS = 1e-14


def _d_mean(vals, mask):
    """The mean of a discriminator map (B, T', D', C), over the valid
    frames of ``mask`` (B, T, 1) where T' = T, else over all of it."""
    if vals.ndim >= 2 and vals.shape[1] == mask.shape[1]:
        m = mask.reshape(mask.shape[0], mask.shape[1],
                         *([1] * (vals.ndim - 2)))
        return masked_mean(vals, m)
    return batch_mean(vals)


def create_gan_train_step(netG, netD, optG, optD, adv_weight: float = 1.0,
                          fm_weight: float = 2.0, recon_weight: float = 1.0,
                          clip_norm: float = 1.0, gan_type: str = "lsgan",
                          stream_sizes: Sequence[int] = None,
                          adv_streams: Sequence[bool] = None,
                          mask_nth_mgc_for_adv_loss: int = 0,
                          vuv_mask: bool = False, use_amp: bool = False,
                          schedG=None, schedD=None, device="cuda"):
    """The GAN step of the JAX package's ``create_gan_train_step``.

    ``netG`` (a postfilter) and ``netD`` (a discriminator returning its
    feature maps, logits last) move to ``device``; ``optG`` / ``optD``
    (and the schedules ``schedG`` / ``schedD``, from ``train/loop.
    build_optimizer``) are built over their parameters.
    ``train_step(batch, generator)`` takes ``in_feats`` (B, T, D) (the
    degraded features), ``out_feats`` (B, T, D) (the targets) and
    ``lengths`` (B,) as tensors on the device, and the CPU
    ``torch.Generator`` that G's noise (and dropout) draws from, and
    returns ``METRIC_KEYS`` as 0-dim tensors on the device.

    * ``gan_type``: ``lsgan``, ``vanilla-gan`` (D's logits as
      probabilities) or ``hinge``.
    * D sees ``adv_streams`` of ``stream_sizes`` (all streams when None),
      without its first ``mask_nth_mgc_for_adv_loss`` dims, times the
      length mask and, with ``vuv_mask``, zero on frames unvoiced in the
      target or the input (the V/UV stream at ``sum(stream_sizes[:2])``).
    * ``use_amp`` runs G in bf16 with float32 master weights; D and every
      loss stay float32.
    * G's loss is taken against D before this step's update and moves
      only G; D's loss is taken on the same forward of the G output and
      moves only D (the JAX step's second D forward, on the detached
      output, gives the same values).  Each network's gradients are
      clipped to ``clip_norm`` on their own; a network whose gradient
      norm is not finite keeps its parameters, optimizer state and
      schedule.

    ``train_step.state["step"]`` counts the calls, as the JAX state's
    ``step``; ``train_step.optimizers`` is (optG, optD)."""
    if gan_type not in GAN_TYPES:
        raise ValueError(f"Unknown gan type: {gan_type}")
    if vuv_mask and (stream_sizes is None or len(stream_sizes) < 3):
        raise ValueError(
            "vuv_mask=True requires stream_sizes (the V/UV stream lives at "
            "sum(stream_sizes[:2]))")
    device = torch.device(device)
    netG.to(device)
    netD.to(device)
    paramsG = list(netG.parameters())
    paramsD = list(netD.parameters())
    state = {"step": 0}

    def adv_input(feats):
        if adv_streams is not None and stream_sizes is not None:
            feats = select_streams(feats, list(stream_sizes),
                                   list(adv_streams))
        if mask_nth_mgc_for_adv_loss > 0:
            feats = feats[:, :, mask_nth_mgc_for_adv_loss:]
        return feats

    def vuv_weight(x, y):
        if not vuv_mask:
            return 1.0
        k = int(sum(stream_sizes[:2]))
        return ((y[:, :, k: k + 1] > 0)
                & (x[:, :, k: k + 1] > 0)).to(torch.float32)

    def g_adv(logits):
        if gan_type == "lsgan":
            return (1.0 - logits) ** 2
        if gan_type == "vanilla-gan":
            return -torch.log(logits + _EPS)
        return -logits

    def d_terms(r, f):
        if gan_type == "lsgan":
            return (r - 1.0) ** 2, f ** 2
        if gan_type == "vanilla-gan":
            return -torch.log(r + _EPS), -torch.log(1.0 - f + _EPS)
        # jnp.maximum's gradient, half at a tie
        zero = torch.zeros_like(r)
        return torch.maximum(1.0 - r, zero), torch.maximum(1.0 + f, zero)

    def train_step(batch: Dict, generator) -> Dict[str, torch.Tensor]:
        x, y, lengths = batch["in_feats"], batch["out_feats"], \
            batch["lengths"]
        T = x.shape[1]
        mask = (torch.arange(T, device=device)[None, :]
                < lengths[:, None]).to(torch.float32)[:, :, None]
        fake = amp_forward(netG, (x, lengths),
                           {"train": True, "generator": generator},
                           use_amp, True)
        loss_recon = masked_mean((fake - y) ** 2, mask)
        w = vuv_weight(x, y) * mask
        d_fake = netD(adv_input(fake) * w)
        d_real = netD(adv_input(y) * w)
        loss_adv = _d_mean(g_adv(d_fake[-1]), mask)
        loss_fm = sum(_d_mean(torch.abs(f - r.detach()), mask)
                      for f, r in zip(d_fake[:-1], d_real[:-1])
                      ) / max(len(d_fake) - 1, 1)
        lossG = (recon_weight * loss_recon + adv_weight * loss_adv
                 + fm_weight * loss_fm)
        real_t, fake_t = d_terms(d_real[-1], d_fake[-1])
        loss_real, loss_fake = _d_mean(real_t, mask), _d_mean(fake_t, mask)
        lossD = loss_real + loss_fake
        with conv_precision(device):
            gradsG = _grads(lossG, paramsG, retain_graph=True)
            gradsD = _grads(lossD, paramsD)
        metrics = reduce_grads(gradsG + gradsD, {
            "Loss_G": lossG, "Loss_Recon": loss_recon, "Loss_Adv": loss_adv,
            "Loss_FM": loss_fm, "Loss_D": lossD, "Loss_D_Real": loss_real,
            "Loss_D_Fake": loss_fake})
        gnormG, finiteG = _clip(gradsG, clip_norm)
        gnormD, finiteD = _clip(gradsD, clip_norm)
        okG, okD = torch.stack([finiteG, finiteD]).tolist()
        for ok, params, grads, opt, sched in (
                (okG, paramsG, gradsG, optG, schedG),
                (okD, paramsD, gradsD, optD, schedD)):
            if ok:
                _apply(params, grads, opt)
                if sched is not None:
                    sched.step()
        state["step"] += 1
        return {**{k: v.detach() for k, v in metrics.items()},
                "GradNorm_G": gnormG, "GradNorm_D": gnormD}

    train_step.state = state
    train_step.optimizers = (optG, optD)
    return train_step
