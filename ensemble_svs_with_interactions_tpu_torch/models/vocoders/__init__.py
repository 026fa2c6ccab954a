"""Neural vocoders (counterparts in
``ensemble_svs_with_interactions_tpu/models/vocoders/``): the uSFGAN
family, Parallel WaveGAN, SiFiGAN and HiFiGAN generators, the inference
wrappers and the host excitation helpers for serving; for training
(``train/vocoder.py``), the generators' ``train_outputs``, the GAN
discriminators (PWG, HiFiGAN multi-period / multi-scale, UnivNet
multi-resolution spectral) and ``CheapTrickLayer``."""

from ensemble_svs_with_interactions_tpu_torch.models.vocoders.cheaptrick import (  # noqa: F401
    CheapTrickLayer,
    source_regularization_loss,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.discriminators import (  # noqa: F401
    HiFiGANMultiPeriodDiscriminator,
    HiFiGANMultiScaleDiscriminator,
    HiFiGANMultiScaleMultiPeriodDiscriminator,
    HiFiGANPeriodDiscriminator,
    HiFiGANScaleDiscriminator,
    PWGDiscriminator,
    UnivNetMultiResolutionMultiPeriodDiscriminator,
    UnivNetMultiResolutionSpectralDiscriminator,
    UnivNetSpectralDiscriminator,
)
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
