"""The vocoder trainer, as ``ensemble_svs_with_interactions_tpu/train/
vocoder_trainer.py`` runs it, and the recipe's stage-10 pack step.

``train_vocoder`` reads ``{utt}-feats.npy`` (normalized acoustic features
in the WORLD layout [mgc, lf0, vuv, bap]) and ``{utt}-wave.npy`` pairs
(``bin/prepare_voc_features.py`` writes them), draws random fixed-length
crops with their sine / noise excitation (``SignalGenerator``) and
pitch-dependent dilation factors, and trains the generator and the
discriminator with ``train/vocoder.py``'s GAN step on ``device="cuda"``
unless the caller passes ``"cpu"``; with ``distributed.coordinator`` set
it is one rank of a data-parallel run (``trainer.join_group``): every
rank draws the same global batch of crops and trains on its rows, and
rank 0 writes.

The crops are the JAX trainer's bit for bit from the same seed: one numpy
``Generator`` seeded ``seed`` draws, per item, the utterance, the start
frame and the excitation's seed, after a one-item probe batch that the
JAX trainer draws first for its ``init``.  They are built and pinned on a
prefetch thread; the copy to the card is issued on the training thread.
The epoch's metrics stay on the device until its end and are read once.
Each epoch writes ``metrics.jsonl`` (``train_no_dev/<key>`` means) and
``latest.ckpt``, and ``best_loss.ckpt`` when the epoch's mean
``Loss_STFT_Mag`` is the lowest so far: the generator's flax-layout
params and its Adam state in optax's layout (``{"0": {"count", "mu",
"nu"}, "1": {}}``), so the JAX package restores either file whole.
"""

from __future__ import annotations

import inspect
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.data.dataset import (
    prefetch_batches,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.cheaptrick import (  # noqa: E501
    CheapTrickLayer,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.usfgan import (
    SignalGenerator,
    dilated_factor,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    MetricsWriter,
    TrainState,
    _moment_tree,
    build_optimizer,
    save_checkpoint,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    barrier,
    batch_sharding,
    replicate_tree,
)
from ensemble_svs_with_interactions_tpu_torch.train.trainer import (
    NoWriter,
    join_group,
    pin_batch,
    to_device,
)
from ensemble_svs_with_interactions_tpu_torch.train.vocoder import (
    create_vocoder_gan_train_step,
    mel_fb_tensor,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    instantiate,
    resolve_target,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from ensemble_svs_with_interactions_tpu_torch.utils.logger import getLogger
from ensemble_svs_with_interactions_tpu_torch.utils.misc import init_seed
from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
    save_model_phase,
)


class _VocoderCrops:
    """Random fixed-length (features, waveform, excitation) crops."""

    def __init__(self, in_dir, sample_rate: int, hop_size: int,
                 crop_frames: int, lf0_idx: int, vuv_idx: int, aux_indices,
                 lf0_mean: float = 0.0, lf0_scale: float = 1.0,
                 signal_types=("sine", "noise"), dense_factor: int = 4,
                 sine_amp: float = 0.1, noise_amp: float = 0.003):
        in_dir = Path(in_dir)
        self.items = []
        for f in sorted(in_dir.glob("*-feats.npy")):
            w = Path(str(f).replace("-feats.npy", "-wave.npy"))
            if w.exists():
                self.items.append((f, w))
        if not self.items:
            raise FileNotFoundError(f"no feats/wave pairs in {in_dir}")
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.crop_frames = crop_frames
        self.lf0_idx = lf0_idx
        self.vuv_idx = vuv_idx
        self.aux_indices = np.asarray(aux_indices)
        self.lf0_mean = lf0_mean
        self.lf0_scale = lf0_scale
        self.dense_factor = dense_factor
        self.signal_generator = SignalGenerator(
            sample_rate, hop_size, sine_amp, noise_amp, list(signal_types))

    def batch(self, rng: np.random.Generator, batch_size: int) -> Dict:
        """{x, c, d, y, f0} float32 arrays; per item ``rng`` draws the
        utterance, then (unless it is no longer than a crop, when it is
        edge-padded from frame 0) the start frame, then the excitation's
        seed."""
        xs, cs, ds, ys, f0s = [], [], [], [], []
        hop, n = self.hop_size, self.crop_frames
        for _ in range(batch_size):
            fpath, wpath = self.items[int(rng.integers(len(self.items)))]
            feats = np.load(fpath)
            wave = np.load(wpath).reshape(-1)
            Tf = min(len(feats), len(wave) // hop)
            if Tf <= n:
                feats = np.pad(feats[:Tf], ((0, n - Tf), (0, 0)),
                               mode="edge")
                wave = np.pad(wave[: Tf * hop], (0, (n - Tf) * hop))
            else:
                start = int(rng.integers(Tf - n))
                feats = feats[start: start + n]
                wave = wave[start * hop: (start + n) * hop]
            lf0 = feats[:, self.lf0_idx] * self.lf0_scale + self.lf0_mean
            vuv = feats[:, self.vuv_idx]
            f0 = np.where(vuv > 0.5, np.exp(lf0), 0.0)
            xs.append(self.signal_generator(f0,
                                            seed=int(rng.integers(1 << 31))))
            ds.append(np.repeat(
                dilated_factor(f0, self.sample_rate, self.dense_factor),
                hop))
            cs.append(feats[:, self.aux_indices])
            ys.append(wave[:, None])
            f0s.append(f0)
        return {"x": np.stack(xs).astype(np.float32),
                "c": np.stack(cs).astype(np.float32),
                "d": np.stack(ds).astype(np.float32),
                "y": np.stack(ys).astype(np.float32),
                "f0": np.stack(f0s).astype(np.float32)}


def stream_layout(config: Config):
    """(sample rate, hop, lf0 index, vuv index, aux indices) of
    ``config.data``: the aux features are mgc and bap."""
    sr = int(config.data.get("sample_rate", 48000))
    hop = int(sr * float(config.data.get("frame_period", 5)) / 1000.0)
    ss = list(config.data.get("stream_sizes", [60, 1, 1, 5]))
    mgc_end = ss[0]
    bap_start = mgc_end + 2
    aux = list(range(0, mgc_end)) + list(range(bap_start,
                                               bap_start + ss[3]))
    return sr, hop, mgc_end, mgc_end + 1, aux


def vocoder_crops(config: Config) -> _VocoderCrops:
    """The training crops of ``config`` (``data.train_no_dev.in_dir``)."""
    sr, hop, lf0_idx, vuv_idx, aux = stream_layout(config)
    return _VocoderCrops(
        config.data.train_no_dev.in_dir, sr, hop,
        crop_frames=int(config.data.get("crop_frames", 64)),
        lf0_idx=lf0_idx, vuv_idx=vuv_idx, aux_indices=aux,
        lf0_mean=float(config.data.get("lf0_mean", 0.0)),
        lf0_scale=float(config.data.get("lf0_scale", 1.0)),
        signal_types=tuple(config.model.get("signal_types",
                                            ["sine", "noise"])),
        dense_factor=int(config.model.get("dense_factor", 4)),
        sine_amp=float(config.model.get("sine_amp", 0.1)),
        noise_amp=float(config.model.get("noise_amp", 0.003)))


def build_generator(config: Config):
    """``config.model.generator``, its excitation width (``in_channels``,
    where the config leaves it out) from ``model.signal_types`` as the
    JAX generators take it from x: the hn-uSFGAN pair splits x into
    [sine, noise] halves."""
    net = dict(config.model.generator)
    cls = resolve_target(net["_target_"])
    if ("in_channels" in inspect.signature(cls).parameters
            and "in_channels" not in net):
        n = len(config.model.get("signal_types", ["sine", "noise"]))
        net["in_channels"] = n // 2 if "Hn" in cls.__name__ else n
    return instantiate(net)


def _weight(train: Config, name: str, alias: str, default: float) -> float:
    return float(train.get(f"lambda_{name}", train.get(alias, default)))


def gan_step(config: Config, generator, discriminator, device):
    """The GAN step ``train_vocoder`` builds from ``config.train`` and
    its two optimizers (``train.optim.net{G,D}.optimizer``): the reference
    trainer's surface (``lambda_*`` or ``*_weight``; ``stft_loss.
    _target_`` naming ``MelSpectralLoss`` selects the log-mel loss;
    ``source_loss`` configures CheapTrick and its mel compression;
    ``fft_sizes`` / ``hop_sizes`` / ``win_lengths``;
    ``discriminator_train_start_steps``)."""
    train = config.train
    sr, hop, *_ = stream_layout(config)
    optG, _ = build_optimizer(generator.parameters(),
                              dict(train.optim.netG.optimizer))
    optD, _ = build_optimizer(discriminator.parameters(),
                              dict(train.optim.netD.optimizer))
    stft_cfg = dict(train.get("stft_loss", {}) or {})
    stft_loss_type = str(train.get("stft_loss_type", ""))
    if not stft_loss_type:
        stft_loss_type = ("mel" if "MelSpectralLoss" in str(
            stft_cfg.get("_target_", "")) else "multi_resolution")
    source_cfg = dict(train.get("source_loss", {}) or {})
    source_weight = _weight(train, "source", "source_weight", 0.0)
    layer = source_fb = None
    if source_weight > 0:
        src_sr = int(source_cfg.get("sampling_rate", sr))
        fft = int(source_cfg.get("fft_size", 4096))
        layer = CheapTrickLayer(
            sample_rate=src_sr, hop_size=hop, fft_size=fft,
            f0_floor=int(source_cfg.get("f0_floor", 70)),
            f0_ceil=int(source_cfg.get("f0_ceil", 1000)), device=device)
        if source_cfg.get("n_mels"):
            source_fb = mel_fb_tensor(src_sr, fft, source_cfg["n_mels"],
                                      source_cfg.get("fmin", 0),
                                      source_cfg.get("fmax", None), device)
    return create_vocoder_gan_train_step(
        generator, discriminator, optG, optD,
        stft_weight=_weight(train, "stft", "stft_weight", 1.0),
        adv_weight=_weight(train, "adv", "adv_weight", 4.0),
        fm_weight=_weight(train, "feat_match", "fm_weight", 0.0),
        fft_sizes=tuple(train.get("fft_sizes", [1024, 2048, 512])),
        hop_sizes=tuple(train.get("hop_sizes", [120, 240, 50])),
        win_lengths=tuple(train.get("win_lengths", [600, 1200, 240])),
        stft_loss_type=stft_loss_type, mel_loss_params=stft_cfg,
        source_weight=source_weight, cheaptrick_layer=layer,
        source_mel_fb=source_fb,
        discriminator_train_start_steps=int(
            train.get("discriminator_train_start_steps", 0)),
        device=device)


def adam_state(module, optimizer) -> Dict:
    """``optimizer``'s Adam state in optax's ``adam`` layout, ``{"0":
    {"count", "mu", "nu"}, "1": {}}``: the count of updates applied (a
    NaN-skipped step applies none), ``mu`` and ``nu`` by the module's flax
    paths."""
    params = list(module.named_parameters())
    names = [n for n, _ in params]
    state = [optimizer.state[p] for _, p in params if p in optimizer.state]
    count = int(state[0]["step"]) if state else 0

    def moments(key):
        return _moment_tree(module, names, [
            optimizer.state[p][key] if p in optimizer.state
            else torch.zeros_like(p) for _, p in params])

    return {"0": {"count": np.asarray(count, np.int32),
                  "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")},
            "1": {}}


def train_vocoder(config: Config, device="cuda") -> Dict[str, float]:
    """Train a vocoder from a config tree with the JAX trainer's keys
    (``data``, ``model.generator``, ``model.discriminator``,
    ``model.signal_types`` ..., ``train``); returns the last epoch's mean
    metrics.  The generator's initial weights are drawn by the flax
    schemes at seed 0 and the discriminator's at seed 1, as JAX's
    ``PRNGKey(0)`` and ``PRNGKey(1)``."""
    logger = getLogger(verbose=config.get("verbose", 1), name="train_voc")
    seed = int(config.get("seed", 1234))
    init_seed(seed)
    device, mesh = join_group(config, device)
    lead = mesh.rank == 0

    generator = init_module(build_generator(config), seed=0)
    discriminator = init_module(instantiate(config.model.discriminator),
                                seed=1)
    for net in (generator, discriminator):  # every rank starts as rank 0
        replicate_tree(net.state_dict(), mesh)
    crops = vocoder_crops(config)
    logger.info("vocoder corpus: %d utterances", len(crops.items))
    rng_np = np.random.default_rng(seed)
    crops.batch(rng_np, 1)  # the JAX trainer's probe batch for its init
    step_fn = gan_step(config, generator, discriminator, device)

    out_dir = Path(config.train.out_dir)
    writer = (MetricsWriter(out_dir, use_tensorboard=config.train.get(
        "use_tensorboard", False)) if lead else NoWriter())
    nepochs = int(config.train.get("nepochs", 10))
    steps_per_epoch = int(config.train.get("steps_per_epoch", 100))
    batch_size = int(config.train.get("batch_size", 8))
    best = float("inf")
    last: Dict[str, float] = {}

    (_, rows), = batch_sharding(mesh, batch_size)

    def crop_batches(n):
        """This rank's rows of each global batch of crops, pinned."""
        for _ in range(n):
            batch = crops.batch(rng_np, batch_size)
            yield pin_batch({k: v[rows] for k, v in batch.items()}, device)

    for epoch in range(1, nepochs + 1):
        epoch_metrics = []
        for pinned in prefetch_batches(crop_batches(steps_per_epoch)):
            metrics = step_fn(to_device(pinned, device))
            epoch_metrics.append(torch.stack(list(metrics.values())))
        keys = list(metrics)
        values = torch.stack(epoch_metrics).mean(0).tolist()
        means = dict(zip(keys, values))
        writer.log(epoch, means, prefix="train_no_dev/")
        logger.info("epoch %d %s", epoch,
                    {k: round(v, 4) for k, v in means.items()})
        last = means
        stft = means.get("Loss_STFT_Mag", float("inf"))
        step = step_fn.state["step"]
        if lead:
            save_checkpoint(out_dir, TrainState(
                params=torch_to_flax(generator)["params"], batch_stats={},
                opt_state=adam_state(generator, step_fn.optimizers[0]),
                step=step),
                epoch, is_best=stft < best)
        barrier()
        best = min(best, stft)
    writer.close()
    return last


def pack_vocoder(train_config: Config, exp_dir, packed_dir) -> Path:
    """The recipe's stage-10 pack step: rebuild the generator of
    ``train_config``, restore ``exp_dir/best_loss.ckpt``'s params and
    write the ``vocoder`` phase (``{"netG": ..., "signal_types": ...}``)
    into ``packed_dir``, which ``SPSVS(model_dir)`` then serves with
    ``vocoder_type="auto"``.  Returns ``packed_dir``."""
    generator = build_generator(train_config)
    tree = flax_msgpack.from_bytes(
        (Path(exp_dir) / "best_loss.ckpt").read_bytes())
    flax_to_torch(generator, {"params": tree["params"]})
    model_cfg = {
        "netG": dict(train_config.model.generator),
        "signal_types": list(train_config.model.get(
            "signal_types", ["sine", "noise"])),
    }
    save_model_phase(packed_dir, "vocoder", model_cfg,
                     torch_to_flax(generator))
    return Path(packed_dir)
