"""Wrapper of the fused decode add + norm kernel (``csrc/residual_norm.cu``).

CPU tensors take the plain version (``ref.decode_residual_norm``); CUDA
tensors launch the hand-written sm_90a kernel or raise. ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from . import ref

LAUNCHES = {"decode_residual_norm": 0}

_LIB = "residual_norm"
_KINDS = {"rmsnorm": 0, "layernorm": 1}


def decode_residual_norm(y: torch.Tensor, x: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         kind: str = "rmsnorm", eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``x += y; h = norm(x)`` -> ``(h, x + y)``, any leading shape
    with D last (reshaped to ``[R, D]`` for the kernel); ``scale`` and
    ``bias`` are ``[D]`` in the activations' dtype (bfloat16 on the card)."""
    if x.device.type == "cpu":
        return ref.decode_residual_norm(y, x, scale, bias, kind=kind, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if kind not in _KINDS:
        raise ValueError(kind)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, got {x.dtype}")
    shape, d = x.shape, x.shape[-1]
    vecs = [scale] + ([] if bias is None else [bias])
    if y.shape != shape or y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"y {y.dtype} {tuple(y.shape)} must match x "
                         f"{x.dtype} {tuple(shape)}")
    for v in vecs:
        if v.dtype != x.dtype or tuple(v.shape) != (d,) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"scale/bias must be contiguous {x.dtype} [{d}] "
                             f"on {x.device}")
    if d * 4 > 227 * 1024:
        raise ValueError(f"D = {d} does not fit the kernel's shared row")
    x2d = x.reshape(-1, d).contiguous()
    y2d = y.reshape(-1, d).contiguous()
    h = torch.empty_like(x2d)
    xo = torch.empty_like(x2d)
    rows = x2d.shape[0]
    if rows:
        fn = _build.bind(_LIB, "decode_residual_norm", 6, 3, 1)
        err = fn(y2d.data_ptr(), x2d.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), h.data_ptr(),
                 xo.data_ptr(), rows, d, _KINDS[kind],
                 float(eps), torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "decode_residual_norm")
        LAUNCHES["decode_residual_norm"] += 1
    return h.reshape(shape), xo.reshape(shape)
