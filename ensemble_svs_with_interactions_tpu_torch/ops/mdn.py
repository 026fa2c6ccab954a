"""Mixture density network head and most-probable-component selection
(``ensemble_svs_with_interactions_tpu/ops/mdn.py``, inference part).

``log_pi`` is (B, T, G), or (B, T, G, D) with ``dim_wise`` mixtures;
``log_sigma`` and ``mu`` are (B, T, G, D).
"""

from __future__ import annotations

import torch
from torch import nn


class MDNLayer(nn.Module):
    """Project hidden features to diagonal-covariance MoG parameters."""

    def __init__(self, in_dim: int, out_dim: int, num_gaussians: int = 30,
                 dim_wise: bool = False):
        super().__init__()
        self.out_dim, self.num_gaussians = out_dim, num_gaussians
        self.dim_wise = dim_wise
        G, D = num_gaussians, out_dim
        self.log_pi = nn.Linear(in_dim, G * D if dim_wise else G)
        self.log_sigma = nn.Linear(in_dim, G * D)
        self.mu = nn.Linear(in_dim, G * D)

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        G, D = self.num_gaussians, self.out_dim
        raw_pi = self.log_pi(x)
        if self.dim_wise:
            raw_pi = raw_pi.reshape(B, T, G, D)
        log_pi = torch.log_softmax(raw_pi, dim=2)
        log_sigma = self.log_sigma(x).reshape(B, T, G, D)
        mu = self.mu(x).reshape(B, T, G, D)
        return log_pi, log_sigma, mu


def mdn_get_most_probable_sigma_and_mu(log_pi, log_sigma, mu):
    """Mean and stddev of the component with the largest mixture weight
    (the first one on ties).  Returns (sigma, mu), each (B, T, D)."""
    if log_pi.ndim == 4:
        idx = torch.argmax(log_pi, dim=2, keepdim=True)  # (B, T, 1, D)
    else:
        idx = torch.argmax(log_pi, dim=2)[:, :, None, None].expand(
            mu.shape[0], mu.shape[1], 1, mu.shape[3])
    max_mu = torch.gather(mu, 2, idx)[:, :, 0, :]
    max_ls = torch.gather(log_sigma, 2, idx)[:, :, 0, :]
    return torch.exp(max_ls), max_mu
