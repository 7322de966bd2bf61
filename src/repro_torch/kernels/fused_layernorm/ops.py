"""Wrappers of the fused residual add + norm kernels: the decode residual
stream's (``csrc/residual_norm.cu``) and the training block's post-norm
site (``csrc/residual_layernorm.cu``).

CPU tensors take the plain versions in ``ref.py``; CUDA tensors launch the
hand-written sm_90a kernels or raise. ``LAUNCHES`` counts kernel launches.
``fused_residual_layernorm`` has a gradient: its backward is the plain
version's (``_grad.PlainBackward``), as JAX differentiates its reference.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .._grad import PlainBackward
from . import ref

LAUNCHES = {"decode_residual_norm": 0, "fused_residual_layernorm": 0}

_LIB = "residual_norm"
_TRAIN_LIB = "residual_layernorm"
_TRAIN_DIMS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
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


def _residual_layernorm_kernel(x: torch.Tensor, residual: torch.Tensor,
                               scale: torch.Tensor,
                               bias: Optional[torch.Tensor], *, eps: float,
                               rms: bool) -> torch.Tensor:
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    y = torch.empty_like(x2d)
    rows = x2d.shape[0]
    if rows:
        fn = _build.bind(_TRAIN_LIB, "fused_residual_layernorm", 5, 4, 1)
        err = fn(x2d.data_ptr(), residual.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 rows, d, int(scale.dtype == torch.float32), int(rms),
                 float(eps), torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "fused_residual_layernorm")
        LAUNCHES["fused_residual_layernorm"] += 1
    return y.reshape(x.shape)


def fused_residual_layernorm(x: torch.Tensor, residual: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             eps: float = 1e-5,
                             rms: bool = False) -> torch.Tensor:
    """``y = norm(x + residual) * scale (+ bias)`` with an fp32 add and
    statistics, in ``x``'s dtype; any leading shape with D last. On the
    card x and residual are contiguous bfloat16, scale and bias ``[D]`` in
    bfloat16 or float32, and D one of 256, 512, ..., 4096 (``_TRAIN_DIMS``).
    Differentiable: backward is the plain version's gradient."""
    plain = functools.partial(ref.fused_residual_layernorm, eps=eps, rms=rms)
    if x.device.type == "cpu":
        return plain(x, residual, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype != torch.bfloat16 or residual.dtype != x.dtype:
        raise TypeError(f"the kernel takes bfloat16 x and residual, got "
                        f"{x.dtype} and {residual.dtype}")
    if residual.shape != x.shape or residual.device != x.device:
        raise ValueError(f"residual {tuple(residual.shape)} must match x "
                         f"{tuple(x.shape)} on {x.device}")
    if d not in _TRAIN_DIMS:
        raise ValueError(f"D = {d}: the kernel is built for D in "
                         f"{_TRAIN_DIMS}")
    vecs = [scale] + ([] if bias is None else [bias])
    for v in vecs:
        if v.dtype not in (torch.bfloat16, torch.float32) \
                or v.dtype != scale.dtype or tuple(v.shape) != (d,) \
                or v.device != x.device:
            raise ValueError(f"scale/bias must be [{d}] tensors of one dtype"
                             f" (bfloat16 or float32) on {x.device}")
    for name, t in (("x", x), ("residual", residual), ("scale", scale),
                    ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned"
                             " (the kernel moves 16 bytes a lane)")
    kernel = functools.partial(_residual_layernorm_kernel, eps=eps, rms=rms)
    return PlainBackward.apply(kernel, plain, x, residual, scale, bias)
