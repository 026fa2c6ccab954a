"""The port's model zoo (the serving and training paths' models); the AR
Tacotron decoders and their ``Prenet`` are in ``models/tacotron.py``, the
diffusion models and the FFT-block encoder in ``models/diffsinger.py``,
the flow-matching decoder in ``models/flow_matching.py``, the conditional
WaveNet in ``models/wavenet.py``, the postfilters' GAN discriminator in
``models/discriminators.py``."""

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
