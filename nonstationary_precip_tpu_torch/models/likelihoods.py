"""Gaussian observation likelihood.

Counterpart of ``nonstationary_precip_tpu/models/likelihoods.py``: GPyTorch's
parameterisation, noise = softplus(raw_noise) + 1e-4 (the
``GreaterThan(1e-4)`` default constraint), raw init 0 → noise ≈ 0.6932.
"""

from __future__ import annotations

import torch
from torch import nn

from nonstationary_precip_tpu_torch.utils.transforms import positive, raw_init

_NOISE_FLOOR = 1e-4


class GaussianLikelihood(nn.Module):
    def __init__(self, raw_noise: torch.Tensor):
        super().__init__()
        self.raw_noise = nn.Parameter(raw_noise)

    @classmethod
    def create(cls, noise: float = None, dtype=torch.float32, device=None):
        if noise is None:
            raw = torch.zeros((), dtype=dtype, device=device)
        else:
            v = torch.as_tensor(noise, dtype=dtype, device=device) - _NOISE_FLOOR
            raw = raw_init(torch.clamp(v, min=1e-8))
        return cls(raw)

    @property
    def noise(self) -> torch.Tensor:
        return positive(self.raw_noise) + _NOISE_FLOOR
