"""Feature scalers (``ensemble_svs_with_interactions_tpu/utils/
scalers.py``): the streaming fit of the recipe's stage 2
(``partial_fit`` / ``fit``, float64 statistics), and transforms with
NumPy in, NumPy out, with the same float32 fast paths; and their ``.npy``
files in a
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
        self._count = 0.0
        self._m2 = None

    def partial_fit(self, x: np.ndarray) -> "StandardScaler":
        """Fold a (N, D) batch into the running statistics (Chan et al.'s
        pairwise update); a scale under sqrt(1e-10) is floored to 1."""
        x = np.asarray(x, dtype=np.float64)
        if self.mean_ is None or self._count == 0:
            self.mean_ = np.zeros(x.shape[-1])
            self._m2 = np.zeros(x.shape[-1])
            self._count = 0.0
        n_b = x.shape[0]
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        n_a, mean_a, m2_a = self._count, self.mean_, self._m2
        n = n_a + n_b
        delta = mean_b - mean_a
        self.mean_ = mean_a + delta * (n_b / n)
        self._m2 = m2_a + m2_b + delta ** 2 * (n_a * n_b / n)
        self._count = n
        self.var_ = self._m2 / self._count
        self.scale_ = np.sqrt(np.where(self.var_ < 1e-10, 1.0, self.var_))
        return self

    def fit(self, x: np.ndarray) -> "StandardScaler":
        self._count = 0.0
        return self.partial_fit(x)

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

    def partial_fit(self, x: np.ndarray) -> "MinMaxScaler":
        """Widen the data range by a (N, D) batch; a zero range maps with
        scale 1."""
        x = np.asarray(x, dtype=np.float64)
        dmin = x.min(axis=0)
        dmax = x.max(axis=0)
        if self.data_min_ is None:
            self.data_min_, self.data_max_ = dmin, dmax
        else:
            self.data_min_ = np.minimum(self.data_min_, dmin)
            self.data_max_ = np.maximum(self.data_max_, dmax)
        fmin, fmax = self.feature_range
        rng = self.data_max_ - self.data_min_
        rng = np.where(rng == 0.0, 1.0, rng)
        self.scale_ = (fmax - fmin) / rng
        self.min_ = fmin - self.data_min_ * self.scale_
        return self

    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        self.data_min_ = None
        return self.partial_fit(x)

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
