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
- ``gated_rmsnorm_partial`` and ``gated_rmsnorm_apply``: the same norm in
  two pieces, for a rank that holds some columns of every row (the model
  axis in training): each row's fp32 sum of squares of the gated product
  over the rank's columns, then, given that sum over the whole row, the
  rank's columns scaled by it. With the whole row in one piece they give
  ``gated_rmsnorm`` but for the order of the statistic's sum.
- ``gated_rmsnorm_split_grads``: the gradients of that split norm, the
  backward that autograd takes of ``gated_rmsnorm`` written out over a
  rank's columns: the same fp32 ops in the same order, the gated product's
  gradient summed in fp32 and rounded once, and the row's sum of
  ``g * scale * gate`` summed over the ranks (``psum``) where autograd
  sums it over the row.
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


def _gated(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (y * (z * torch.sigmoid(z))).float()


def gated_rmsnorm_partial(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Each row's fp32 sum of squares of the gated product over the columns
    given: [..., C] -> [...]."""
    return torch.sum(torch.square(_gated(y, z)), dim=-1)


def gated_rmsnorm_apply(y: torch.Tensor, z: torch.Tensor, sq: torch.Tensor,
                        scale: torch.Tensor, c: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """The columns given of rows of ``c`` columns in all, normed by each
    row's sum of squares ``sq`` [...] over all ``c`` (``gated_rmsnorm``'s
    second half): ``g * rsqrt(sq / c + eps) * scale`` in ``y``'s dtype."""
    var = (sq.float() / c)[..., None]
    return (_gated(y, z) * torch.rsqrt(var + eps)
            * scale.float()).to(y.dtype)


def gated_rmsnorm_split_grads(y: torch.Tensor, z: torch.Tensor,
                              scale: torch.Tensor, sq: torch.Tensor,
                              g: torch.Tensor, c: int, eps: float = 1e-5,
                              psum=None) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``gated_rmsnorm_apply(y, z, sq, scale, c)`` where
    ``sq`` is the row statistic summed over every rank's columns (of
    ``gated_rmsnorm_partial``), for the output gradient ``g`` -> (dy, dz,
    dscale). Each op is the one autograd runs for ``gated_rmsnorm`` over a
    whole row, in its order: so the statistic's share of the gated
    product's gradient is added to the direct share in fp32 and rounded to
    y's dtype once, as there. The row's sum of ``g * scale * gate`` (the
    rsqrt's gradient) is this rank's columns' sum, summed over the ranks
    by ``psum`` (in place; None: one piece holds the whole row)."""
    with torch.enable_grad():
        yd = y.detach().requires_grad_(True)
        zd = z.detach().requires_grad_(True)
        yf = _gated(yd, zd)
    p = yf.detach()
    rs = torch.rsqrt(sq.float()[..., None] / c + eps)
    gf = g.float()
    da = gf * scale.float()                       # d(p * rs)
    dscale = torch.sum((gf * (p * rs)).reshape(-1, p.shape[-1]),
                       dim=0).to(scale.dtype)
    drs = torch.sum(da * p, dim=-1, keepdim=True)
    if psum is not None:
        drs = psum(drs)
    dvar = -0.5 * drs * rs.pow(3)
    dyf = da * rs + (dvar / c) * (2 * p)
    dy, dz = torch.autograd.grad(yf, (yd, zd), dyf)
    return dy, dz, dscale
