"""Transform-only feature scalers (the inference half of
``ensemble_svs_with_interactions_tpu/utils/scalers.py``): NumPy in, NumPy
out, with the same float32 fast paths; and their ``.npy`` files in a
packed model directory (``{prefix}_min.npy`` / ``_scale.npy`` for a
``MinMaxScaler``, ``{prefix}_mean.npy`` / ``_var.npy`` / ``_scale.npy`` for
a ``StandardScaler``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_static_features,
)


class StandardScaler:
    """Standardization scaler: (x - mean) / scale."""

    def __init__(self, mean=None, var=None, scale=None):
        self.mean_ = mean
        self.var_ = var
        self.scale_ = scale

    def transform(self, x):
        if isinstance(x, np.ndarray) and x.dtype == np.float32:
            out = x - np.asarray(self.mean_, np.float32)
            out /= np.asarray(self.scale_, np.float32)
            return out
        return (x - self.mean_) / self.scale_

    def inverse_transform(self, x):
        if isinstance(x, np.ndarray) and x.dtype == np.float32:
            out = x * np.asarray(self.scale_, np.float32)
            out += np.asarray(self.mean_, np.float32)
            return out
        return x * self.scale_ + self.mean_


class MinMaxScaler:
    """Min-max scaler: scale_ * x + min_ maps data range to feature_range."""

    def __init__(self, min=None, scale=None, data_min=None, data_max=None,
                 feature_range=(0.0, 1.0)):
        self.min_ = min
        self.scale_ = scale
        self.data_min_ = data_min
        self.data_max_ = data_max
        self.feature_range = feature_range

    def transform(self, x):
        if isinstance(x, np.ndarray) and x.dtype == np.float32:
            out = x * np.asarray(self.scale_, np.float32)
            out += np.asarray(self.min_, np.float32)
            return out
        return self.scale_ * x + self.min_

    def inverse_transform(self, x):
        if isinstance(x, np.ndarray) and x.dtype == np.float32:
            out = x - np.asarray(self.min_, np.float32)
            out /= np.asarray(self.scale_, np.float32)
            return out
        return (x - self.min_) / self.scale_


def extract_static_scaler(out_scaler: StandardScaler,
                          stream_sizes: Sequence[int],
                          has_dynamic_features: Sequence[bool],
                          num_windows: int) -> StandardScaler:
    """Build a static-features-only scaler from a static+dynamic scaler."""

    def _static(v):
        parts = get_static_features(
            np.asarray(v).reshape(1, 1, -1), num_windows,
            list(stream_sizes), list(has_dynamic_features),
        )
        return np.concatenate(parts, axis=-1).reshape(-1)

    return StandardScaler(_static(out_scaler.mean_), _static(out_scaler.var_),
                          _static(out_scaler.scale_))


def load_standard_scaler(prefix) -> StandardScaler:
    """A StandardScaler from ``{prefix}_{mean,var,scale}.npy``."""
    return StandardScaler(np.load(f"{prefix}_mean.npy"),
                          np.load(f"{prefix}_var.npy"),
                          np.load(f"{prefix}_scale.npy"))


def load_minmax_scaler(prefix) -> MinMaxScaler:
    """A MinMaxScaler from ``{prefix}_{min,scale}.npy``."""
    return MinMaxScaler(np.load(f"{prefix}_min.npy"),
                        np.load(f"{prefix}_scale.npy"))


def save_scaler(scaler, prefix) -> None:
    """Write a scaler's statistics as ``.npy`` files under ``prefix``."""
    if isinstance(scaler, StandardScaler):
        stats = {"mean": scaler.mean_, "var": scaler.var_,
                 "scale": scaler.scale_}
    elif isinstance(scaler, MinMaxScaler):
        stats = {"min": scaler.min_, "scale": scaler.scale_}
    else:
        raise TypeError(f"unknown scaler type: {type(scaler)}")
    for name, value in stats.items():
        np.save(f"{prefix}_{name}.npy", value)
