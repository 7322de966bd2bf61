"""Wrapper of the fused scale + causal mask + softmax kernel
(``csrc/scale_mask_softmax.cu``).

Dispatch is on the tensor's device: CPU tensors take the plain PyTorch
version in ``ref.py``; CUDA tensors launch the hand-written sm_90a kernel
or raise. There is no fallback from one to the other. ``LAUNCHES`` counts
the kernel's launches (plain calls do not count). The input contract is
checked on both devices: contiguous fp32 or bf16 scores, no gradient (the
JAX kernel has no VJP either). As ``repro.kernels.fused_softmax.ops``,
``[..., Sq, Sk]`` is taken as the 3-D ``[N, Sq, Sk]``; unlike the TPU
kernel, any Sq is taken, and Sk up to ``MAX_SK``.

``softmax_plan`` picks the kernel's variant from the shapes alone: a warp
a row for short rows, else a CTA a row.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ...core import optrace
from .. import _build
from . import ref

LAUNCHES = {"scale_mask_softmax": 0}

_LIB = "scale_mask_softmax"
DTYPES = (torch.float32, torch.bfloat16)
MAX_SK = 32768          # 32 elements a thread of a 1024-thread CTA (kMaxSk)
VECS = {torch.float32: (4, 1), torch.bfloat16: (8, 4, 1)}  # elements a load
WARP_PER = (4, 8, 16)   # elements a lane of a warp a row, as instantiated
CTA_PER = (16, 32)      # elements a thread of a CTA a row
# a warp a row while a lane holds at most 16 elements: past that a CTA a
# row of 16 a thread is faster (at Sk 1500 bf16, 0.147 ms on a warp of 64
# a lane, 0.085 on a CTA of 96 threads: softmax_ablations.py on an H100)
WARP_MAX_SK = 32 * WARP_PER[-1]
CTA_WIDE_SK = 1024 * 16          # 32 a thread past this
WARP_THREADS = 128               # 4 rows a CTA


class SoftmaxPlan(NamedTuple):
    cta: bool       # a CTA a row (else a warp a row)
    vec: int        # elements a load: 16 bytes, else 8, else 1 element
    per: int        # elements a lane (warp) or a thread (CTA) at most
    threads: int    # threads a CTA


@functools.lru_cache(maxsize=None)
def softmax_plan(rows: int, sk: int, dtype: torch.dtype) -> SoftmaxPlan:
    """The kernel's variant for ``rows`` rows of ``sk`` scores of
    ``dtype``: a warp a row (``WARP_THREADS`` / 32 rows a CTA, the fewest
    elements a lane that hold the row, no fewer than a load's) up to
    ``WARP_MAX_SK``, else a CTA a row of 16 elements a thread (32 past
    ``CTA_WIDE_SK`` columns), its threads the fewest whole warps that hold
    the row. A load is the widest of ``VECS[dtype]`` that divides ``sk``.
    Pure in its arguments."""
    if dtype not in DTYPES:
        raise TypeError(f"no softmax plan for {dtype}")
    if not 1 <= sk <= MAX_SK or rows < 1:
        raise ValueError(f"no softmax plan for {rows} rows of {sk}")
    vec = next(v for v in VECS[dtype] if sk % v == 0)
    if sk <= WARP_MAX_SK:
        per = next(p for p in WARP_PER if 32 * p >= sk and p >= vec)
        return SoftmaxPlan(False, vec, per, WARP_THREADS)
    per = 16 if sk <= CTA_WIDE_SK else 32
    return SoftmaxPlan(True, vec, per, 32 * -(-sk // (32 * per)))


def _check(s: torch.Tensor) -> None:
    if s.dtype not in DTYPES:
        raise TypeError(f"scale_mask_softmax takes float32 or bfloat16 "
                        f"scores, got {s.dtype}")
    if s.dim() < 2:
        raise ValueError(f"need scores [..., Sq, Sk], got {tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("scale_mask_softmax needs contiguous scores")
    if torch.is_grad_enabled() and s.requires_grad:
        raise NotImplementedError(
            "scale_mask_softmax has no backward (the JAX kernel has no VJP "
            "either)")


def scale_mask_softmax_flops(s: torch.Tensor, *, scale: float, causal: bool,
                             q_offset: int = 0) -> float:
    """FLOPs of one call, as its plain version's ops count them
    (``core/characterize.py``): scale, row max, subtract, exp, row sum and
    divide (6 an element); causal, the mask's [Sq, Sk] compare, the row
    positions and the select."""
    n = s.numel()
    if not causal:
        return 6.0 * n
    sq, sk = s.shape[-2], s.shape[-1]
    return 7.0 * n + sq + sq * sk


@optrace.kernel_op("scale_mask_softmax", scale_mask_softmax_flops)
def scale_mask_softmax(s: torch.Tensor, *, scale: float, causal: bool,
                       q_offset: int = 0) -> torch.Tensor:
    """s [..., Sq, Sk] raw scores -> softmax(scale * s + causal mask) over
    the last axis in s's dtype; query row i sits at position i + q_offset
    and, where causal, sees columns 0..i + q_offset."""
    _check(s)
    if s.device.type == "cpu":
        return ref.scale_mask_softmax(s, scale=scale, causal=causal,
                                      q_offset=q_offset)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    sk = s.shape[-1]
    rows = s.numel() // sk if sk else 0
    if sk > MAX_SK:
        raise ValueError(f"Sk = {sk}: the kernel keeps a row in registers "
                         f"and takes Sk up to {MAX_SK}")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows: the kernel takes fewer than 2^31")
    y = torch.empty_like(s)
    if rows == 0:
        return y
    plan = softmax_plan(rows, sk, s.dtype)
    if s.data_ptr() % (plan.vec * s.element_size()):
        plan = plan._replace(vec=1)    # a base the vectors cannot align to
    _launch(s, y, plan, scale=scale, causal=causal, q_offset=q_offset)
    LAUNCHES["scale_mask_softmax"] += 1
    return y


def _launch(s: torch.Tensor, y: torch.Tensor, plan: SoftmaxPlan, *,
            scale: float, causal: bool, q_offset: int,
            lib: str = _LIB) -> None:
    """One launch of library ``lib``'s kernel on checked tensors at
    ``plan`` (a plan other than ``softmax_plan``'s, or ``lib`` other than
    the package's own, only for ``softmax_ablations.py``)."""
    sq, sk = s.shape[-2], s.shape[-1]
    fn = _build.bind(lib, "scale_mask_softmax", 2, 10, 1)
    err = fn(s.data_ptr(), y.data_ptr(), s.numel() // sk, sq, sk,
             int(q_offset), int(bool(causal)), int(s.dtype == torch.bfloat16),
             int(plan.cta), plan.vec, plan.per, plan.threads,
             float(scale), torch.cuda.current_stream(s.device).cuda_stream)
    _build.check(err, "scale_mask_softmax")
