"""Evaluation metrics: RMSE (both reference conventions), joint and marginal
NLPD.

Counterpart of ``nonstationary_precip_tpu/train/metrics.py``; reductions run
over the last axis, so a leading split axis passes through.
"""

from __future__ import annotations

import math

import torch


def rmse_rescaled(y_pred_mean, y_test, y_std) -> torch.Tensor:
    """RMSE rescaled by Y_std (the reference's utils/metrics.py)."""
    return y_std * torch.sqrt(torch.mean((y_pred_mean - y_test) ** 2, dim=-1))


def rmse_raw(y_pred_mean, y_test) -> torch.Tensor:
    """RMSE with no rescale (the reference's utils/metrics2.py)."""
    return torch.sqrt(torch.mean((y_pred_mean - y_test) ** 2, dim=-1))


def nlpd_joint(pred_dist, y_test, y_std) -> torch.Tensor:
    """−(joint log p(y) / N − log Y_std); ``pred_dist`` is an MVN."""
    lpd = pred_dist.log_prob(y_test)
    log_std = torch.log(torch.as_tensor(y_std, dtype=lpd.dtype, device=lpd.device))
    return -(lpd / y_test.shape[-1] - log_std)


def nlpd_marginal(y_test, pred_mean, pred_var) -> torch.Tensor:
    """Mean per-point Gaussian negative log density (the reference's
    ``negative_log_predictive_density``)."""
    lpd = -0.5 * ((y_test - pred_mean) ** 2 / pred_var + torch.log(2 * math.pi * pred_var))
    return -torch.mean(lpd, dim=-1)
