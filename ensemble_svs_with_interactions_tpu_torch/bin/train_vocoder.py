"""Vocoder GAN trainer (uSFGAN family, Parallel WaveGAN, HiFiGAN).

``python -m ensemble_svs_with_interactions_tpu_torch.bin.train_vocoder
config.yaml [key=value ...]``: the config has the JAX trainer's keys (a
``configs/vocoder/*.yaml`` with ``data.train_no_dev.in_dir`` and
``train.out_dir`` set); ``device=cpu`` trains on the CPU, otherwise on
the card.
"""

from ensemble_svs_with_interactions_tpu_torch.bin import run_trainer
from ensemble_svs_with_interactions_tpu_torch.train.vocoder_trainer import (
    train_vocoder,
)


def main(argv=None) -> int:
    return run_trainer(lambda config, _, device: train_vocoder(config, device),
                       None, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
