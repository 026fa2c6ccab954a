"""Acoustic models of the flagship, single-track, multi-speaker, Sinsy
residual-F0, NPSS (single-track AR and MDN, multi-speaker MDN, multitrack
diffusion) and mel paths."""

from ensemble_svs_with_interactions_tpu_torch.models.acoustic.multistream import (  # noqa: F401,E501
    MDNMultistreamSeparateF0MelModel,
    MultiSpeakerMultistreamSeparateF0ParametricModel,
    MultistreamSeparateF0MelModel,
    MultistreamSeparateF0ParametricModel,
    MultiTrackMultistreamSeparateF0ParametricModel,
    MultiTrackMultistreamSeparateF0ParametricModelv3,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.tacotron_f0 import (  # noqa: F401,E501
    BiLSTMMDNNonAttentiveDecoder,
    BiLSTMNonAttentiveDecoder,
    BiLSTMResF0NonAttentiveDecoder,
    MDNResF0NonAttentiveDecoder,
    MultiTrackBiLSTMResF0NonAttentiveDecoder,
    ResF0NonAttentiveDecoder,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.npss import (  # noqa: F401,E501
    MultiSpeakerNPSSMDNMultistreamParametricModel,
    MultiTrackNPSSMDNMultistreamParametricModel,
    NPSSMDNMultistreamParametricModel,
    NPSSMultistreamParametricModel,
    V2MultiTrackNPSSMDNMultistreamParametricModel,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.resf0 import (  # noqa: F401,E501
    ResF0Conv1dResnet,
    ResF0TransformerEncoder,
    ResF0VariancePredictor,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic.sinsy import (  # noqa: F401,E501
    ResSkipF0FFConvLSTM,
)
