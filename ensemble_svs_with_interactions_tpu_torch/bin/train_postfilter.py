"""Learned-postfilter GAN trainer (LSGAN, vanilla GAN or hinge with
feature matching over a postfilter / ``Conv2dD`` pair).

``python -m ensemble_svs_with_interactions_tpu_torch.bin.train_postfilter
config.yaml [key=value ...]``: the config has the JAX trainer's keys
(``data.{train_no_dev,dev}.{in_dir,out_dir}``, ``model.netG``,
``model.netD``, ``train``); ``device=cpu`` trains on the CPU, otherwise on
the card.
"""

from ensemble_svs_with_interactions_tpu_torch.bin import run_trainer
from ensemble_svs_with_interactions_tpu_torch.train.postfilter_trainer import (  # noqa: E501
    train_postfilter,
)


def main(argv=None) -> int:
    return run_trainer(
        lambda config, _, device: train_postfilter(config, device), None,
        __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
