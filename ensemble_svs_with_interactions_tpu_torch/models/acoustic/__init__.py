"""Acoustic models of the flagship, single-track and multitrack NPSS
(diffusion) paths."""

from ensemble_svs_with_interactions_tpu_torch.models.acoustic.multistream import (  # noqa: F401,E501
    MultistreamSeparateF0ParametricModel,
    MultiTrackMultistreamSeparateF0ParametricModel,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.tacotron_f0 import (  # noqa: F401,E501
    BiLSTMResF0NonAttentiveDecoder,
    MultiTrackBiLSTMResF0NonAttentiveDecoder,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.npss import (  # noqa: F401,E501
    MultiTrackNPSSMDNMultistreamParametricModel,
    V2MultiTrackNPSSMDNMultistreamParametricModel,
)
