"""Multi-speaker acoustic trainer CLI: the single-track trainer with
``is_acoustic=True``; setting ``data.spk_names`` switches the dataset to
speaker ids from the file names' prefixes and feeds the model's ``spks``.

``python -m ensemble_svs_with_interactions_tpu_torch.bin.train_acoustic_multi
config.yaml [key=value ...]``: the config has the JAX trainer's keys;
``device=cpu`` trains on the CPU, otherwise on the card.
"""

from ensemble_svs_with_interactions_tpu_torch.bin import run_trainer
from ensemble_svs_with_interactions_tpu_torch.train import trainer


def main(argv=None) -> int:
    return run_trainer(trainer.train_model, True, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
