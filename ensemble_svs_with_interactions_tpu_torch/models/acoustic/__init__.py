"""Acoustic models of the flagship, single-track, Sinsy residual-F0,
NPSS (single-track AR and MDN, multitrack diffusion) and mel paths."""

from ensemble_svs_with_interactions_tpu_torch.models.acoustic.multistream import (  # noqa: F401,E501
    MDNMultistreamSeparateF0MelModel,
    MultistreamSeparateF0MelModel,
    MultistreamSeparateF0ParametricModel,
    MultiTrackMultistreamSeparateF0ParametricModel,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.tacotron_f0 import (  # noqa: F401,E501
    BiLSTMNonAttentiveDecoder,
    BiLSTMResF0NonAttentiveDecoder,
    MultiTrackBiLSTMResF0NonAttentiveDecoder,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.npss import (  # noqa: F401,E501
    MultiTrackNPSSMDNMultistreamParametricModel,
    NPSSMDNMultistreamParametricModel,
    NPSSMultistreamParametricModel,
    V2MultiTrackNPSSMDNMultistreamParametricModel,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.resf0 import (  # noqa: F401,E501
    ResF0Conv1dResnet,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.sinsy import (  # noqa: F401,E501
    ResSkipF0FFConvLSTM,
)
