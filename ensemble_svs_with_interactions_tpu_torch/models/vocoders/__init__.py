"""Neural vocoders for serving (counterparts in
``ensemble_svs_with_interactions_tpu/models/vocoders/``): the uSFGAN
family, Parallel WaveGAN, SiFiGAN and HiFiGAN generators, the inference
wrappers and the host excitation helpers.  The discriminators and
``CheapTrickLayer`` belong to vocoder training, which the port has not
ported."""

from ensemble_svs_with_interactions_tpu_torch.models.vocoders.sifigan import (  # noqa: F401
    HiFiGANGenerator,
    SiFiGANGenerator,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.usfgan import (  # noqa: F401
    CascadeHnUSFGANGenerator,
    ParallelHnUSFGANGenerator,
    PeriodicityEstimator,
    PWGGenerator,
    SignalGenerator,
    USFGANGenerator,
    USFGANWrapper,
    VocoderPack,
    dilated_factor,
)
