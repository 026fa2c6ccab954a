"""The port's model zoo (the serving and training paths' models); the
diffusion models are in ``models/diffsinger.py``, the postfilters' GAN
discriminator in ``models/discriminators.py``."""

from ensemble_svs_with_interactions_tpu_torch.models.generic import (  # noqa: F401
    FFConvLSTM,
    LSTMEncoder,
    MDN,
    MDNv2,
    MultiTrackLSTMEncoder,
    MultiTrackVariancePredictor,
    SpeakerEmbedding,
    VariancePredictor,
)
from ensemble_svs_with_interactions_tpu_torch.models import (  # noqa: F401,E402
    diffsinger,
)
