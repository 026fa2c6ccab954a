"""The port's model zoo (the flagship path's models)."""

from ensemble_svs_with_interactions_tpu_torch.models.generic import (  # noqa: F401
    FFConvLSTM,
    LSTMEncoder,
    MultiTrackLSTMEncoder,
    MultiTrackVariancePredictor,
    SpeakerEmbedding,
    VariancePredictor,
)
