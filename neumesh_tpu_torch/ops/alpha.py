"""NeuS opacity/transmittance math (counterpart of neumesh_tpu/ops/alpha.py).
Epsilon placement matches the reference exactly."""
from __future__ import annotations

import torch


def cdf_Phi_s(x, s):
    """NeuS CDF: sigmoid(s * x)."""
    return torch.sigmoid(x * s)


def sdf_to_alpha(sdf, s):
    """sdf (..., N) -> (cdf (..., N), alpha (..., N - 1)),
    alpha_i = clamp((Phi_i - Phi_{i+1}) / (Phi_i + 1e-10), min=0)."""
    cdf = cdf_Phi_s(sdf, s)
    alpha = (cdf[..., :-1] - cdf[..., 1:]) / (cdf[..., :-1] + 1e-10)
    return cdf, torch.clamp(alpha, min=0.0)


def alpha_to_w(alpha):
    """w_i = alpha_i * prod_{j<i}(1 - alpha_j + 1e-10)."""
    shifted = torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1)
    return alpha * torch.cumprod(shifted, dim=-1)[..., :-1]
