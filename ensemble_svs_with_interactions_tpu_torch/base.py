"""Base model contract, as in ``ensemble_svs_with_interactions_tpu/base.py``.

Inference entry points are ``inference(...)`` (MDN models return
``(mu, sigma)``); ``prediction_type()`` is the metadata the generation
pipeline reads.
"""

from __future__ import annotations

import enum

from torch import nn


class PredictionType(enum.Enum):
    DETERMINISTIC = 1
    PROBABILISTIC = 2
    MULTISTREAM_HYBRID = 3
    DIFFUSION = 4


class BaseModel(nn.Module):
    """Common superclass for the port's models."""

    def inference(self, x, lengths=None):
        return self(x, lengths)

    def prediction_type(self) -> PredictionType:
        return PredictionType.DETERMINISTIC
