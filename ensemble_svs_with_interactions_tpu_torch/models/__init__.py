"""The port's model zoo, under the names the JAX package's ``models``
exports: the base contract (``BaseModel``, ``PredictionType``), the
generic models, the masked ``LSTM``, the AR Tacotron decoders and their
``Prenet``, the flow-matching decoders and the learned postfilters
(``Conv2dPostFilter``, ``MultistreamPostFilter``).  The diffusion models
and the FFT-block encoder are in ``models/diffsinger.py``, the conditional
WaveNet in ``models/wavenet.py``, the postfilters' GAN discriminator in
``models/discriminators.py``, the acoustic models in ``models/acoustic``."""

from ensemble_svs_with_interactions_tpu_torch.base import (  # noqa: F401
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.generic import (  # noqa: F401
    FFN,
    LSTMRNN,
    LSTMRNNSAR,
    MDN,
    RMDN,
    Conv1dResnet,
    Conv1dResnetMDN,
    Conv1dResnetSAR,
    FeedForwardNet,
    FFConvLSTM,
    LSTMEncoder,
    MDNv2,
    MultiSpeakerFFConvLSTM,
    MultiTrackLSTMEncoder,
    MultiTrackVariancePredictor,
    SpeakerEmbedding,
    TransformerEncoder,
    VariancePredictor,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import (  # noqa: F401,E402,E501
    LSTM,
)
from ensemble_svs_with_interactions_tpu_torch.models.tacotron import (  # noqa: F401,E402,E501
    MDNNonAttentiveDecoder,
    NonAttentiveDecoder,
    Prenet,
)
from ensemble_svs_with_interactions_tpu_torch.models import (  # noqa: F401,E402
    diffsinger,
    flow_matching,
    wavenet,
)
from ensemble_svs_with_interactions_tpu_torch.models.flow_matching import (  # noqa: F401,E402,E501
    FlowMatching,
    MultiSpeakerFlowMatching,
)
from ensemble_svs_with_interactions_tpu_torch.models.wavenet import (  # noqa: F401,E402,E501
    WaveNet,
)
from ensemble_svs_with_interactions_tpu_torch.models.postfilters import (  # noqa: F401,E402,E501
    Conv2dPostFilter,
    MultistreamPostFilter,
)
