"""The port's command-line entry points (``python -m
ensemble_svs_with_interactions_tpu_torch.bin.<name>``)."""

import sys

from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    load_config,
    merge,
    parse_overrides,
)


def run_trainer(train_fn, is_acoustic: bool, doc: str, argv=None) -> int:
    """``config.yaml [key=value ...]``: load the config, apply the
    overrides and train with ``train_fn(config, is_acoustic, device)`` on
    the config's ``device`` (``cuda`` unless ``device=cpu``)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(doc)
        return 1
    config = load_config(argv[0])
    if len(argv) > 1:
        config = merge(config, parse_overrides(argv[1:]))
    train_fn(config, is_acoustic, device=config.get("device", "cuda"))
    return 0
