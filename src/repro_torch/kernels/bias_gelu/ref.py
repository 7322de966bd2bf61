"""Plain PyTorch version of the fused bias + GeLU kernel. Counterpart of
``repro.kernels.bias_gelu.ref``: the bias is added in ``x``'s dtype and the
tanh-approximate GeLU applied to the sum (the kernel computes in fp32).
``gelu_as_sigmoid`` is the form the kernel evaluates, for the tests."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...models.layers import gelu

# -2 sqrt(2 / pi) log2(e), and times 0.044715 (the kernel's kA, kB)
_A = -2.0 * math.sqrt(2.0 / math.pi) * math.log2(math.e)
_B = _A * 0.044715


def bias_gelu(x: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = x if bias is None else x + bias.to(x.dtype)
    return gelu(h)


def gelu_as_sigmoid(h: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GeLU as the kernel writes it: 0.5 h (1 +
    tanh(u)) = h sigmoid(2u) = h / (1 + 2^(h (A + B h^2))), A = -2 sqrt(2 /
    pi) log2(e), B = 0.044715 A, in ``h``'s dtype (the kernel: fp32, with
    ``ex2.approx`` and a fast reciprocal)."""
    return h / (1 + torch.exp2(h * (_B * (h * h) + _A)))
