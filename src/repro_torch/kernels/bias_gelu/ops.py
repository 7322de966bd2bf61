"""Wrapper of the fused bias + GeLU kernel (``csrc/bias_gelu.cu``).

CPU tensors take the plain version (``ref.bias_gelu``); CUDA tensors launch
the hand-written sm_90a kernel or raise. ``LAUNCHES`` counts kernel
launches. The backward is the plain version's gradient
(``_grad.PlainBackward``): the JAX package has no backward kernel either.
The launch grid is ``gelu_plan``, a pure function of the shape and the
card's SM count.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import _build
from .._grad import PlainBackward
from . import ref

LAUNCHES = {"bias_gelu": 0}

_LIB = "bias_gelu"
THREADS = 256           # a CTA (the kernel's kThreads)
ROWS_IN_FLIGHT = 4      # 16-byte loads of x a thread issues at once
CTAS_PER_SM = 4         # the grid's target: one wave of this many a SM


class GeluPlan(NamedTuple):
    """CTAs (gx, gy) of threads (tx, ty): tx threads across a row's
    8-column chunks, ty rows of threads; each thread ``rows_per_thread``
    rows of its chunk."""
    tx: int
    ty: int
    gx: int
    gy: int
    rows_per_thread: int


@functools.lru_cache(maxsize=None)
def gelu_plan(rows: int, f: int, sms: int) -> GeluPlan:
    """The grid for x [rows, f] (f % 8 == 0) on a card of ``sms`` SMs:
    a row's chunks across the threads of a CTA (up to 256, in whole warps;
    narrow rows stack several rows of threads in a CTA), then rows split
    so the grid is about ``CTAS_PER_SM`` CTAs a SM, each thread taking at
    least ``ROWS_IN_FLIGHT`` rows (a whole multiple of it)."""
    chunks = f // 8
    tx = min(THREADS, 32 * -(-chunks // 32))
    ty = THREADS // tx
    gx = -(-chunks // tx)
    target = max(1, sms * CTAS_PER_SM // gx)
    per = -(-rows // (ty * target))
    per = ROWS_IN_FLIGHT * max(1, -(-per // ROWS_IN_FLIGHT))
    gy = -(-rows // (ty * per))
    return GeluPlan(tx, ty, gx, gy, per)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x: torch.Tensor, bias: Optional[torch.Tensor], y: torch.Tensor,
            plan: GeluPlan, lib: str = _LIB) -> None:
    """One launch on checked CUDA tensors (``bias_gelu`` checks) with the
    given plan and library (another build of the source, for ablations)."""
    f = x.shape[-1]
    fn = _build.bind(lib, "bias_gelu", 3, 8)
    err = fn(x.data_ptr(), None if bias is None else bias.data_ptr(),
             y.data_ptr(), x.numel() // f, f,
             int(bias is not None and bias.dtype == torch.float32), *plan,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bias_gelu")


def _kernel(x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    y = torch.empty_like(x)
    if x.numel():
        f = x.shape[-1]
        _launch(x, bias, y, gelu_plan(x.numel() // f, f, _sms(x.device)))
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
