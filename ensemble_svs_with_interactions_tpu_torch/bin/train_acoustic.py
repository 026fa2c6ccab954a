"""Single-track acoustic trainer (pitch regularization, dev distortions).

``python -m ensemble_svs_with_interactions_tpu_torch.bin.train_acoustic
config.yaml [key=value ...]``: the config has the JAX trainer's keys
(``model``, ``data``, ``train``, ...); ``device=cpu`` trains on the CPU,
otherwise on the card.
"""

from ensemble_svs_with_interactions_tpu_torch.bin import run_trainer
from ensemble_svs_with_interactions_tpu_torch.train.trainer import (
    train_model,
)


def main(argv=None) -> int:
    return run_trainer(train_model, True, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
