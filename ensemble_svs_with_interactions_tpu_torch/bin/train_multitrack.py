"""Multitrack timelag/duration trainer.

``python -m ensemble_svs_with_interactions_tpu_torch.bin.train_multitrack
config.yaml [key=value ...]``: the config has the JAX trainer's keys
(``model``, ``data``, ``train``, ...); ``device=cpu`` trains on the CPU,
otherwise on the card.
"""

from ensemble_svs_with_interactions_tpu_torch.bin import run_trainer
from ensemble_svs_with_interactions_tpu_torch.train.multitrack_trainer import (
    train_multitrack_model,
)


def main(argv=None) -> int:
    return run_trainer(train_multitrack_model, False, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
