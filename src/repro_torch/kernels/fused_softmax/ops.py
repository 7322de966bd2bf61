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
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

LAUNCHES = {"scale_mask_softmax": 0}

_LIB = "scale_mask_softmax"
DTYPES = (torch.float32, torch.bfloat16)
MAX_SK = 32768          # the kernel's fp32 row in shared memory (kMaxSk)


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
    sq, sk = s.shape[-2], s.shape[-1]
    rows = s.numel() // sk if sk else 0
    if sk > MAX_SK:
        raise ValueError(f"Sk = {sk}: the kernel keeps a row in shared "
                         f"memory and takes Sk up to {MAX_SK}")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows: the kernel takes fewer than 2^31")
    y = torch.empty_like(s)
    if rows == 0:
        return y
    fn = _build.bind(_LIB, "scale_mask_softmax", 2, 6, 1)
    err = fn(s.data_ptr(), y.data_ptr(), rows, sq, sk, int(q_offset),
             int(bool(causal)), int(s.dtype == torch.bfloat16), float(scale),
             torch.cuda.current_stream(s.device).cuda_stream)
    _build.check(err, "scale_mask_softmax")
    LAUNCHES["scale_mask_softmax"] += 1
    return y
