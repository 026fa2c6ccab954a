"""Acoustic models of the flagship path."""

from ensemble_svs_with_interactions_tpu_torch.models.acoustic.multistream import (  # noqa: F401,E501
    MultiTrackMultistreamSeparateF0ParametricModel,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.tacotron_f0 import (  # noqa: F401,E501
    MultiTrackBiLSTMResF0NonAttentiveDecoder,
)
