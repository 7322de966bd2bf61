"""Wrappers of the fused norm kernels: the decode residual stream's add +
norm (``csrc/residual_norm.cu``), the training block's post-norm site
(``csrc/residual_layernorm.cu``) and the mamba mixer's SiLU-gated RMSNorm
(``csrc/gated_rmsnorm.cu``).

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

LAUNCHES = {"decode_residual_norm": 0, "fused_residual_layernorm": 0,
            "gated_rmsnorm": 0}

_LIB = "residual_norm"
_TRAIN_LIB = "residual_layernorm"
_GATED_LIB = "gated_rmsnorm"
# the gated bf16 row is kept in shared memory beside the kernel's 36 bytes
# of static shared memory (its reduction scratch), within Hopper's 227 KB
_GATED_MAX_C = (227 * 1024 - 36) // 2 // 8 * 8
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


def _rows(t: torch.Tensor, name: str, c: int) -> torch.Tensor:
    """``t`` as a ``[R, C]`` view with unit column stride, a row stride
    that is a multiple of 8 and a 16-byte aligned base; raises otherwise
    (the kernel moves 8 bf16 values a lane). Leading dims are merged
    without a copy where the strides allow it, so a column slice of a
    wider row (z inside the in_proj output) keeps its row stride."""
    t2 = t.reshape(-1, c)
    if t2.stride(1) != 1 or (t2.shape[0] > 1 and t2.stride(0) % 8) \
            or t2.data_ptr() % 16:
        raise ValueError(f"{name} must have unit column stride, a row stride "
                         f"that is a multiple of 8 and a 16-byte aligned "
                         f"base, got strides {t2.stride()}")
    return t2


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """SiLU-gated RMSNorm (the mamba mixer epilogue): ``rmsnorm(y *
    silu(z)) * scale``, any leading shape with the channel dim C last. On
    the card y, z and scale are bfloat16, C a multiple of 8, and y and z
    may be row-strided views (z is a column slice of the in_proj
    output); the result is a new contiguous tensor of y's shape."""
    if y.device.type == "cpu":
        return ref.gated_rmsnorm(y, z, scale, eps=eps)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    c = y.shape[-1]
    for name, t in (("y", y), ("z", z), ("scale", scale)):
        if t.dtype != torch.bfloat16 or t.device != y.device:
            raise TypeError(f"the kernel takes bfloat16 tensors on "
                            f"{y.device}; {name} is {t.dtype} on {t.device}")
    if z.shape != y.shape or tuple(scale.shape) != (c,):
        raise ValueError(f"y {tuple(y.shape)}, z {tuple(z.shape)} and scale "
                         f"{tuple(scale.shape)} must be [..., C], [..., C] "
                         "and [C]")
    if c % 8 or c > _GATED_MAX_C:
        raise ValueError(f"C = {c}: the kernel takes a multiple of 8 up to "
                         f"{_GATED_MAX_C} (its shared row)")
    y2d, z2d = _rows(y, "y", c), _rows(z, "z", c)
    if not scale.is_contiguous() or scale.data_ptr() % 16:
        raise ValueError("scale must be contiguous and 16-byte aligned")
    out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    rows = y2d.shape[0]
    if rows:
        fn = _build.bind(_GATED_LIB, "gated_rmsnorm", 4, 4, 1)
        err = fn(y2d.data_ptr(), z2d.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), rows, c, y2d.stride(0), z2d.stride(0),
                 float(eps), torch.cuda.current_stream(y.device).cuda_stream)
        _build.check(err, "gated_rmsnorm")
        LAUNCHES["gated_rmsnorm"] += 1
    return out
