"""cuDNN's precision around a CUDA call.

Importing the port turns TF32 off for cuDNN convolutions, as the JAX
package computes them in float32.  cuDNN's switch is process-wide, so a
module that must run its convolutions in a given precision whatever the
caller set (the learned postfilter, the diffusion chain) says so around
each CUDA call with :func:`conv_precision`, one thread at a time.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# the host postprocess runs tracks on threads
_CUDNN_LOCK = threading.Lock()


@contextlib.contextmanager
def conv_precision(device: torch.device, allow_tf32: bool = False):
    """Within the block cuDNN's convolutions on ``device`` take TF32 or
    not, as ``allow_tf32`` says; a CPU device changes nothing."""
    if device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    with _CUDNN_LOCK, cudnn.flags(enabled=cudnn.enabled,
                                  benchmark=cudnn.benchmark,
                                  deterministic=cudnn.deterministic,
                                  allow_tf32=allow_tf32):
        yield
