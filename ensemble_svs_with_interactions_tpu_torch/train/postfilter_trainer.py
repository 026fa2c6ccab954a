"""The learned postfilter's GAN trainer, as ``ensemble_svs_with_
interactions_tpu/train/postfilter_trainer.py`` runs it.

``data.{train_no_dev,dev}.in_dir`` hold the acoustic model's predicted
statics and ``out_dir`` the ground-truth statics, both normalized, paired
by ``{utt}-feats.npy`` name (the recipe's stage 8 writes them).  The
postfilter ``model.netG`` trains against ``model.netD`` with
``train/gan.py``'s step on ``device="cuda"`` unless the caller passes
``"cpu"``; with ``distributed.coordinator`` set it is one rank of a
data-parallel run (``trainer.join_group``): every rank builds the same
global batches, trains on its rows (G's noise the global batch's, cut to
them) and rank 0 writes.

Batches are the JAX trainer's: ``BucketedBatchIterator`` over
``FeatsDataset``, shuffled with ``seed=epoch``, built and pinned on a
prefetch thread.  G's noise is drawn from one CPU ``torch.Generator``
seeded ``seed`` (JAX splits a ``PRNGKey(seed)`` per step); the dev pass
scores the reconstruction with noise from a generator seeded 0 for each
batch, as JAX's fixed ``PRNGKey(0)``.  The initial weights are drawn by
the flax schemes at seed 0 for G and seed 2 for D, as JAX's ``PRNGKey(0)``
and ``PRNGKey(2)``.

Each epoch writes ``metrics.jsonl`` (``train_no_dev/<key>`` means and
``dev/Loss_Recon``) and ``latest.ckpt``, and ``best_loss.ckpt`` when the
epoch's dev reconstruction loss is the lowest so far.  A checkpoint holds
G alone, in the JAX ``TrainState`` layout: its flax params and, for Adam
at a constant rate, its Adam state in optax's layout, so the recipe's
stage 9 and ``bin/merge_postfilters.py`` of either package read it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

from ensemble_svs_with_interactions_tpu_torch.data.dataset import (
    BucketedBatchIterator,
    FeatsDataset,
    prefetch_batches,
)
from ensemble_svs_with_interactions_tpu_torch.train.gan import (
    create_gan_train_step,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    MetricsWriter,
    TrainState,
    build_optimizer,
    save_checkpoint,
)
from ensemble_svs_with_interactions_tpu_torch.train.losses import masked_mean
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    barrier,
    batch_sharding,
    replicate_tree,
)
from ensemble_svs_with_interactions_tpu_torch.train.trainer import (
    NoWriter,
    join_group,
    pin_batch,
    rows_of,
    to_device,
)
from ensemble_svs_with_interactions_tpu_torch.train.vocoder_trainer import (
    adam_state,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from ensemble_svs_with_interactions_tpu_torch.utils.logger import getLogger
from ensemble_svs_with_interactions_tpu_torch.utils.misc import init_seed


def build_postfilter(config: Config):
    """``config.model.netG``, its feature width fixed for frame-wise
    noise from ``model.in_dim`` or, where that is 0 or absent, from the
    first training input (flax infers it from the input)."""
    netG = instantiate(config.model.netG)
    if getattr(netG, "in_dim", 0) is None:
        D = int(config.model.get("in_dim", 0) or 0)
        if not D:
            d = config.data.train_no_dev
            D = FeatsDataset(d.in_dir, d.out_dir)[0][0].shape[-1]
        netG.set_in_dim(D)
    return netG


def _optimizer(module, optim: Config):
    """(optimizer, schedule, whether its state has optax's ``adam``
    layout) of ``train.optim.net{G,D}``."""
    opt_cfg = dict(optim.optimizer)
    sched_cfg = dict(optim.get("lr_scheduler", {}) or {})
    opt, sched = build_optimizer(module.parameters(), opt_cfg, sched_cfg)
    params = dict(opt_cfg.get("params", {}) or {})
    plain_adam = (str(opt_cfg.get("name", "Adam")).lower() == "adam"
                  and float(params.get("weight_decay", 0.0)) == 0.0
                  and not sched_cfg)
    return opt, sched, plain_adam


def gan_step(config: Config, netG, netD, device):
    """The GAN step ``train_postfilter`` builds from ``config.train`` (the
    reference's ``mse_weight`` or ``recon_weight``, ``adv_weight``,
    ``fm_weight``, ``gan_type``, ``adv_streams`` over ``model.
    stream_sizes``, ``mask_nth_mgc_for_adv_loss``, ``vuv_mask``,
    ``use_amp``, ``optim.clip_norm``) and ``train.optim.net{G,D}``;
    its ``g_checkpoint()`` is G's ``TrainState`` at that moment."""
    train = config.train
    optG, schedG, plain_adam = _optimizer(netG, train.optim.netG)
    optD, schedD, _ = _optimizer(netD, train.optim.netD)
    adv_streams = train.get("adv_streams", None)
    stream_sizes = list(config.model.get("stream_sizes", []) or [])
    if adv_streams is not None and len(adv_streams) != len(stream_sizes):
        raise ValueError("adv_streams must be specified for all streams")
    step = create_gan_train_step(
        netG, netD, optG, optD,
        adv_weight=float(train.get("adv_weight", 1.0)),
        fm_weight=float(train.get("fm_weight", 2.0)),
        recon_weight=float(train.get("mse_weight",
                                     train.get("recon_weight", 1.0))),
        clip_norm=float(train.optim.get("clip_norm", 1.0)),
        gan_type=str(train.get("gan_type", "lsgan")),
        stream_sizes=stream_sizes or None,
        adv_streams=list(adv_streams) if adv_streams is not None else None,
        mask_nth_mgc_for_adv_loss=int(train.get("mask_nth_mgc_for_adv_loss",
                                                0)),
        vuv_mask=bool(train.get("vuv_mask", False)),
        use_amp=bool(train.get("use_amp", False)),
        schedG=schedG, schedD=schedD, device=device)
    step.g_checkpoint = lambda: _g_state(netG, optG, schedG, plain_adam,
                                         step.state["step"])
    return step


def _g_state(netG, optG, schedG, plain_adam: bool, step: int) -> TrainState:
    """G's checkpoint: flax params, no batch stats, its optimizer state
    (optax's ``adam`` layout for plain Adam, else the port's)."""
    if plain_adam:
        return TrainState(params=torch_to_flax(netG)["params"],
                          batch_stats={}, opt_state=adam_state(netG, optG),
                          step=step)
    state = TrainState.capture(netG, optG, schedG, step)
    state.batch_stats = {}
    return state


def train_postfilter(config: Config, device="cuda") -> Dict[str, float]:
    """Train a postfilter from a config tree with the JAX trainer's keys
    (``data``, ``model.netG``, ``model.netD``, ``train``); returns the
    last epoch's means (the training metrics and ``Dev_Loss_Recon``)."""
    logger = getLogger(verbose=config.get("verbose", 1), name="train_pf")
    seed = int(config.get("seed", 1234))
    init_seed(seed)
    device, mesh = join_group(config, device)
    lead = mesh.rank == 0

    netG = init_module(build_postfilter(config), seed=0)
    netD = init_module(instantiate(config.model.netD), seed=2)
    step_fn = gan_step(config, netG, netD, device)
    for net in (netG, netD):  # every rank starts as rank 0
        replicate_tree(net.state_dict(), mesh)

    max_frames = int(config.data.get("filter_num_frames", 6000))
    batch_max_frames = int(config.data.get("batch_max_frames", 8000))
    time_multiple = int(config.data.get("time_multiple", 32))
    datasets = {}
    for split in ("train_no_dev", "dev"):
        d = config.data[split]
        datasets[split] = FeatsDataset(d["in_dir"], d["out_dir"],
                                       max_frames=max_frames)
        logger.info("%s: %d utterances", split, len(datasets[split]))

    out_dir = Path(config.train.out_dir)
    writer = (MetricsWriter(out_dir, use_tensorboard=config.train.get(
        "use_tensorboard", False)) if lead else NoWriter())
    nepochs = int(config.train.get("nepochs", 10))
    generator = torch.Generator().manual_seed(seed)
    best = float("inf")
    last: Dict[str, float] = {}

    def batches(split, epoch):
        """(global batch, this rank's rows pinned) pairs."""
        train = split == "train_no_dev"
        for batch in BucketedBatchIterator(
                datasets[split], max_tokens=batch_max_frames,
                time_multiple=time_multiple, batch_multiple=mesh.world_size,
                shuffle=train, seed=epoch if train else 0):
            (_, sl), = batch_sharding(mesh, len(batch["lengths"]))
            yield batch, pin_batch({k: v[sl] for k, v in batch.items()},
                                   device)

    @torch.no_grad()
    def eval_recon(b):
        x, y, lengths = b["in_feats"], b["out_feats"], b["lengths"]
        mask = (torch.arange(x.shape[1], device=device)[None, :]
                < lengths[:, None]).to(torch.float32)[:, :, None]
        fake = netG(x, lengths, train=False,
                    generator=torch.Generator().manual_seed(0))
        return all_reduce_sum(masked_mean((fake - y) ** 2, mask))

    for epoch in range(1, nepochs + 1):
        epoch_metrics = []
        for batch, pinned in prefetch_batches(batches("train_no_dev",
                                                       epoch)):
            with rows_of(mesh, batch):
                metrics = step_fn(to_device(pinned, device), generator)
            epoch_metrics.append(torch.stack(list(metrics.values())))
        means = dict(zip(metrics, torch.stack(epoch_metrics).mean(0)
                         .tolist())) if epoch_metrics else {}
        writer.log(epoch, means, prefix="train_no_dev/")
        dev_losses = []
        for batch, pinned in prefetch_batches(batches("dev", 0)):
            with rows_of(mesh, batch):
                dev_losses.append(eval_recon(to_device(pinned, device)))
        if dev_losses:
            means["Dev_Loss_Recon"] = float(torch.stack(dev_losses).mean())
            writer.log(epoch, {"Loss_Recon": means["Dev_Loss_Recon"]},
                       prefix="dev/")
        logger.info("epoch %d %s", epoch,
                    {k: round(v, 4) for k, v in means.items()})
        last = means
        gen_loss = means.get("Dev_Loss_Recon",
                             means.get("Loss_Recon", float("inf")))
        if lead:
            save_checkpoint(out_dir, step_fn.g_checkpoint(), epoch,
                            is_best=gen_loss < best)
        barrier()
        best = min(best, gen_loss)
    writer.close()
    return last
