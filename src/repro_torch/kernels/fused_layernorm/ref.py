"""Plain PyTorch version of the decode residual stream's fused add + norm.
Counterpart of ``repro.kernels.fused_layernorm.ref.decode_residual_norm``.

The add runs in the model dtype and the norm is the port's own
``models.layers.apply_norm``, called as is: the pair is then bitwise equal
to the unfused ``x = x + y; h = apply_norm(x)`` by construction, which is
what lets the fused decode stack emit the unfused stack's tokens on the CPU.
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
