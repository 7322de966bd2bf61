"""Plain PyTorch version of the fused LAMB kernels (the paper's Fig. 3,
Stage 1 + Stage 2). Counterpart of ``repro.kernels.fused_lamb.ref``.

The trust ratio is one per leaf: the port keeps one tensor per layer, so a
leaf is a layer, as Fig. 3 and ``repro.optim.lamb`` reduce it. (The JAX
package's Pallas path reduces per last-axis row instead; the port follows
the reference.) ``ginv``, ``c1`` and ``c2`` may be Python floats or 0-d
tensors on the leaf's device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def lamb_stage1(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, ginv, c1, c2, beta1: float, beta2: float,
                eps: float, weight_decay: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (m', v', u): the update direction before the trust ratio."""
    gn = g.float() * ginv
    m_new = beta1 * m + (1.0 - beta1) * gn
    v_new = beta2 * v + (1.0 - beta2) * torch.square(gn)
    u = (m_new * c1) / (torch.sqrt(v_new * c2) + eps) + weight_decay * w
    return m_new, v_new, u


def trust_ratio(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``||w|| / ||u||`` over the whole leaf (1 where either norm is 0)."""
    wn = torch.sqrt(torch.sum(torch.square(w)))
    un = torch.sqrt(torch.sum(torch.square(u)))
    return torch.where((wn > 0) & (un > 0), wn / torch.clamp_min(un, 1e-30),
                       torch.ones_like(wn))


def lamb_stage2(w: torch.Tensor, u: torch.Tensor, *, lr: float,
                r: torch.Tensor) -> torch.Tensor:
    """w' = w - lr * r * u."""
    return w - lr * r * u


def lamb_stage12(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, *, ginv, c1, c2, beta1: float, beta2: float,
                 eps: float, weight_decay: float, lr: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The full Fig. 3 update of one leaf -> (w', m', v', trust ratio)."""
    m_new, v_new, u = lamb_stage1(w, g, m, v, ginv=ginv, c1=c1, c2=c2,
                                  beta1=beta1, beta2=beta2, eps=eps,
                                  weight_decay=weight_decay)
    r = trust_ratio(w, u)
    return lamb_stage2(w, u, lr=lr, r=r), m_new, v_new, r
