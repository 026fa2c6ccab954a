"""Host helpers of the trainers (``init_seed`` of
``ensemble_svs_with_interactions_tpu/utils/misc.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def init_seed(seed: int) -> None:
    """Seed the host's global RNGs: Python's, NumPy's and torch's.  The
    trainers draw dropout from explicit generators; this covers everything
    else."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
