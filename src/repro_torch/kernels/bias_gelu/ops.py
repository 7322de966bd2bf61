"""Wrapper of the fused bias + GeLU kernel (``csrc/bias_gelu.cu``).

CPU tensors take the plain version (``ref.bias_gelu``); CUDA tensors launch
the hand-written sm_90a kernel or raise. ``LAUNCHES`` counts kernel
launches. The backward is the plain version's gradient
(``_grad.PlainBackward``): the JAX package has no backward kernel either.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .._grad import PlainBackward
from . import ref

LAUNCHES = {"bias_gelu": 0}

_LIB = "bias_gelu"


def _kernel(x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        fn = _build.bind(_LIB, "bias_gelu", 3, 3)
        err = fn(x.data_ptr(), None if bias is None else bias.data_ptr(),
                 y.data_ptr(), n, x.shape[-1],
                 int(bias is not None and bias.dtype == torch.float32),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "bias_gelu")
        LAUNCHES["bias_gelu"] += 1
    return y


def bias_gelu(x: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tanh-GeLU(x + bias), any leading shape with F last. On the card x is
    contiguous bfloat16 with F a multiple of 8, and ``bias`` ``[F]`` in
    bfloat16 or float32. Differentiable: backward is the plain version's
    gradient."""
    if x.device.type == "cpu":
        return ref.bias_gelu(x, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    f = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 x, got {x.dtype}")
    if f % 8:
        raise ValueError(f"F = {f} must be a multiple of 8 (16-byte lanes)")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{x.numel()} elements: the kernel takes < 2^31")
    if bias is not None and (bias.dtype not in (torch.bfloat16, torch.float32)
                             or tuple(bias.shape) != (f,)
                             or bias.device != x.device):
        raise ValueError(f"bias must be a bfloat16 or float32 [{f}] tensor "
                         f"on {x.device}")
    for name, t in (("x", x), ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return PlainBackward.apply(_kernel, ref.bias_gelu, x, bias)
