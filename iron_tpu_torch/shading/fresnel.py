"""Microfacet building blocks: Smith G1 shadowing, the GGX NDF and exact
Fresnel terms for dielectrics and conductors (counterpart of
iron_tpu/shading/fresnel.py).  Pure tensor functions, broadcast over any
leading dims."""
from __future__ import annotations

import math

import torch


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def smith_g1(cos_theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    tan_theta = sin_theta / (cos_theta + 1e-10)
    root = alpha * tan_theta
    return 2.0 / (1.0 + torch.hypot(root, torch.ones_like(root)))


def ggx_ndf(cos_theta: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """GGX normal distribution at the half-vector cosine."""
    cos2 = cos_theta * cos_theta
    root = cos2 + (1.0 - cos2) / (alpha * alpha + 1e-10)
    return 1.0 / (math.pi * alpha * alpha * root * root + 1e-10)


def fresnel_dielectric(cos_theta_i: torch.Tensor, eta) -> torch.Tensor:
    """Unpolarised dielectric Fresnel reflectance; `eta` is the relative
    IOR, and rays exiting (cos < 0) use 1/eta for the Snell scale."""
    eta = torch.broadcast_to(_like(eta, cos_theta_i), cos_theta_i.shape)
    scale = torch.where(cos_theta_i > 0, 1.0 / eta, eta)
    cos_t_sqr = 1.0 - (1.0 - cos_theta_i ** 2) * scale ** 2
    cos_i = torch.abs(cos_theta_i)
    cos_t = torch.sqrt(torch.clamp(cos_t_sqr, min=0.0))
    Rs = (cos_i - eta * cos_t) / (cos_i + eta * cos_t)
    Rp = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
    F = 0.5 * (Rs * Rs + Rp * Rp)
    return torch.where(cos_t_sqr <= 0.0, torch.ones_like(F), F)  # total internal reflection


def fresnel_conductor_exact(cos_theta_i: torch.Tensor, eta, k) -> torch.Tensor:
    """Exact conductor Fresnel (Mitsuba's util.cpp form)."""
    eta = _like(eta, cos_theta_i)
    k = _like(k, cos_theta_i)
    cos2 = cos_theta_i * cos_theta_i
    sin2 = 1.0 - cos2
    sin4 = sin2 * sin2
    temp1 = eta * eta - k * k - sin2
    a2pb2 = torch.sqrt(torch.clamp(temp1 * temp1 + 4 * k * k * eta * eta, min=0.0))
    a = torch.sqrt(torch.clamp(0.5 * (a2pb2 + temp1), min=0.0))
    term1 = a2pb2 + cos2
    term2 = 2 * a * cos_theta_i
    Rs2 = (term1 - term2) / (term1 + term2)
    term3 = a2pb2 * cos2 + sin4
    term4 = term2 * sin2
    Rp2 = Rs2 * (term3 - term4) / (term3 + term4)
    return 0.5 * (Rp2 + Rs2)
