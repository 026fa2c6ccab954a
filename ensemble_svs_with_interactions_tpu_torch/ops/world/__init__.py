"""WORLD: codec decode and coded-stream synthesis on the device (one
device, or one track's frames sharded over a mesh), and the host-side
analysis and coders of feature extraction (``analysis``, ``codec``)."""

from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (  # noqa: F401
    code_aperiodicity,
    code_spectral_envelope,
    decode_aperiodicity,
    get_cheaptrick_fft_size,
    get_num_aperiodicities,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world.synthesis import (  # noqa: F401
    quantize_peak_norm_int16,
    synthesize,
    synthesize_from_streams,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world.analysis import (  # noqa: F401
    cheaptrick,
    d4c,
    dio,
    harvest,
    stonemask,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world.synthesis_sharded import (  # noqa: F401
    synthesize_from_streams_time_sharded,
    synthesize_time_sharded,
)
