"""Plain PyTorch versions of the fused residual + norm kernels.
Counterparts of ``repro.kernels.fused_layernorm.ref``.

- ``decode_residual_norm``: the decode residual stream's add + norm. The add
  runs in the model dtype and the norm is the port's own
  ``models.layers.apply_norm``, called as is: the pair is then bitwise equal
  to the unfused ``x = x + y; h = apply_norm(x)`` by construction, which is
  what lets the fused decode stack emit the unfused stack's tokens on the CPU.
- ``fused_residual_layernorm``: the training block's post-norm site (the
  paper's Fig. 13 "LN" fusion). The add runs in fp32, so it matches the
  unfused ``apply_norm(x + y)`` (a model-dtype add) to rounding, not bitwise.
- ``gated_rmsnorm``: the mamba mixer's epilogue, verbatim the JAX reference:
  the SiLU gate in the model dtype (three roundings: ``sigmoid(z)``,
  ``z * s``, ``y * g``), then an fp32 RMSNorm times the scale.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...models.layers import apply_norm


def decode_residual_norm(y: torch.Tensor, x: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         kind: str = "rmsnorm", eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x += y; h = norm(x)`` -> ``(h, x + y)``, any leading shape, D last."""
    x2 = x + y
    p = {"scale": scale} if bias is None else {"scale": scale, "bias": bias}
    return apply_norm(kind, p, x2, eps), x2


def fused_residual_layernorm(x: torch.Tensor, residual: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             eps: float = 1e-5,
                             rms: bool = False) -> torch.Tensor:
    """``y = norm(x + residual) * scale (+ bias)``: the add and the
    statistics in fp32, the result in ``x``'s dtype; any leading shape."""
    h = x.float() + residual.float()
    if rms:
        var = torch.mean(torch.square(h), dim=-1, keepdim=True)
        y = h * torch.rsqrt(var + eps)
    else:
        mu = torch.mean(h, dim=-1, keepdim=True)
        var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
        y = (h - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """SiLU-gated RMSNorm of the mamba mixer output, any leading shape with
    the channel dim last: ``rmsnorm(y * silu(z)) * scale`` in ``y``'s
    dtype."""
    yf = (y * (z * torch.sigmoid(z))).float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)
