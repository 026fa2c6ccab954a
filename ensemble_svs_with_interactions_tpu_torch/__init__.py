"""PyTorch/CUDA port of ``ensemble_svs_with_interactions_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside this one is the reference; this package imports
nothing of it (nor JAX).  Module names and layout follow the JAX package
so each module's counterpart is easy to find.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

Importing the package turns TF32 off for matmuls and cuDNN convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``): the JAX package computes these in
full float32 (it runs the vocoder's cepstrum matmul at
``Precision.HIGHEST``), and TF32 keeps only about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
