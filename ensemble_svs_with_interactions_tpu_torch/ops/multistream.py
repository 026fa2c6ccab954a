"""Multi-stream feature utilities (stream split, static extraction,
per-stream MLPG), as in ``ensemble_svs_with_interactions_tpu/ops/
multistream.py``.  Slicing works on NumPy arrays and torch tensors alike;
MLPG runs on the host."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.ops.mlpg import (
    default_windows,
    mlpg,
)

get_windows = default_windows


def _start_indices(stream_sizes: Sequence[int]) -> List[int]:
    out = [0]
    for s in stream_sizes[:-1]:
        out.append(out[-1] + int(s))
    return out


def split_streams(inputs, stream_sizes: Sequence[int]):
    """Split concatenated multi-stream features into a list of streams."""
    return [inputs[..., start: start + int(size)]
            for start, size in zip(_start_indices(stream_sizes), stream_sizes)]


def get_static_stream_sizes(stream_sizes: Sequence[int],
                            has_dynamic_features: Sequence[bool],
                            num_windows: int) -> np.ndarray:
    """Static-only sizes of streams that carry delta features."""
    sizes = np.asarray(stream_sizes, dtype=np.int64).copy()
    mask = np.asarray(has_dynamic_features, dtype=bool)
    sizes[mask] = sizes[mask] // num_windows
    return sizes


def get_static_features(inputs, num_windows: int,
                        stream_sizes: Sequence[int],
                        has_dynamic_features: Sequence[bool]):
    """Static parts of static+dynamic multi-stream features, one array per
    stream (a single array for one stream)."""
    D = inputs.shape[-1]
    if len(stream_sizes) == 1:
        if has_dynamic_features[0]:
            return inputs[..., : D // num_windows]
        return inputs
    ret = []
    for start, size, dyn in zip(_start_indices(stream_sizes), stream_sizes,
                                has_dynamic_features):
        size = int(size)
        ret.append(inputs[..., start: start + (size // num_windows if dyn
                                               else size)])
    return ret


def multi_stream_mlpg(inputs: np.ndarray, variances, windows,
                      stream_sizes: Sequence[int],
                      has_dynamic_features: Sequence[bool]) -> np.ndarray:
    """Per-stream MLPG over (T, D) static+dynamic means; ``variances`` is
    (T, D) or (D,).  Returns (T, sum of static sizes)."""
    T, D = inputs.shape
    if D != int(np.sum(stream_sizes)):
        raise RuntimeError(
            f"stream sizes {stream_sizes} do not sum to feature dim {D}")
    variances = np.asarray(variances)
    per_frame_var = variances.ndim == 2
    ret = []
    for start, size, dyn in zip(_start_indices(stream_sizes), stream_sizes,
                                has_dynamic_features):
        size = int(size)
        x = inputs[:, start: start + size]
        var = (variances[:, start: start + size] if per_frame_var
               else variances[start: start + size])
        ret.append(np.asarray(mlpg(x, var, windows)) if dyn else np.asarray(x))
    return np.concatenate(ret, axis=-1)
