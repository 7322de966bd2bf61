"""Plain PyTorch version of the fused bias + GeLU kernel. Counterpart of
``repro.kernels.bias_gelu.ref``: the bias is added in ``x``'s dtype and the
tanh-approximate GeLU applied to the sum (the kernel computes in fp32)."""
from __future__ import annotations

from typing import Optional

import torch

from ...models.layers import gelu


def bias_gelu(x: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = x if bias is None else x + bias.to(x.dtype)
    return gelu(h)
