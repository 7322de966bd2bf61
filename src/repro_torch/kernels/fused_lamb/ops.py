"""Wrapper of the fused LAMB kernels (``csrc/fused_lamb.cu``): one leaf's
Fig. 3 update, in place.

CPU tensors take the plain version (``ref.lamb_stage12``) and copy its
results into ``w``, ``m`` and ``v``; CUDA tensors launch the two
hand-written sm_90a kernels or raise. ``LAUNCHES`` counts kernel launches.
Nothing here reads a device value on the host: ``ginv``, ``c1`` and ``c2``
arrive as a 3-float device tensor, and stage 2 reduces stage 1's per-block
partial norms itself, so a step of many leaves never waits on the card.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

LAUNCHES = {"lamb_stage1": 0, "lamb_stage2": 0}

_LIB = "fused_lamb"
_THREADS = 256
_MAX_BLOCKS = 4 * 132        # four CTAs on each of the H100's 132 SMs


def grid_blocks(n: int) -> int:
    """CTAs of both stages for an ``n``-element leaf (each thread takes four
    elements a sweep; grid-stride beyond ``_MAX_BLOCKS``)."""
    return max(1, min(_MAX_BLOCKS, -(-n // (4 * _THREADS))))


def lamb_update_(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, scalars: torch.Tensor, *, beta1: float,
                 beta2: float, eps: float, weight_decay: float,
                 lr: float) -> torch.Tensor:
    """LAMB Stage 1 + 2 on one leaf: ``w``, ``m``, ``v`` (float32) updated
    in place from the gradient ``g`` (float32 or bfloat16, read in its own
    dtype); ``scalars`` = [ginv, c1, c2] float32. Returns the leaf's trust
    ratio as a 1-element float32 tensor on the leaf's device."""
    if w.device.type == "cpu":
        w_new, m_new, v_new, r = ref.lamb_stage12(
            w, g, m, v, ginv=scalars[0], c1=scalars[1], c2=scalars[2],
            beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
            lr=lr)
        w.copy_(w_new)
        m.copy_(m_new)
        v.copy_(v_new)
        return r.reshape(1)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    for name, t in (("w", w), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (3,):
        raise ValueError("scalars must be a float32 [3] tensor (ginv, c1, c2)")
    for name, t in (("w", w), ("g", g), ("m", m), ("v", v),
                    ("scalars", scalars)):
        if t.device != w.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {w.device}")
        if t is not scalars and t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match w "
                             f"{tuple(w.shape)}")
    n = w.numel()
    if not 0 < n < 2 ** 31:
        raise ValueError(f"leaf of {n} elements: the kernel takes 1 to 2^31-1")
    blocks = grid_blocks(n)
    u = torch.empty(n, dtype=torch.float32, device=w.device)
    partials = torch.empty(2 * blocks, dtype=torch.float32, device=w.device)
    r = torch.empty(1, dtype=torch.float32, device=w.device)
    stage1(w, g, m, v, scalars, u, partials, beta1=beta1, beta2=beta2,
           eps=eps, weight_decay=weight_decay)
    stage2(w, u, partials, r, lr=lr)
    return r


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def stage1(w, g, m, v, scalars, u, partials, *, beta1: float, beta2: float,
           eps: float, weight_decay: float) -> None:
    """Launch stage 1 on checked CUDA tensors (``lamb_update_`` checks):
    m, v in place, u and ``partials`` [2 * grid_blocks(n)] written."""
    n = w.numel()
    fn = _build.bind(_LIB, "lamb_stage1", 7, 3, 6)
    err = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
             scalars.data_ptr(), u.data_ptr(), partials.data_ptr(), n,
             grid_blocks(n), int(g.dtype == torch.float32), beta1,
             1.0 - beta1, beta2, 1.0 - beta2, eps, weight_decay, _stream(w))
    _build.check(err, "lamb_stage1")
    LAUNCHES["lamb_stage1"] += 1


def stage2(w, u, partials, r, *, lr: float) -> None:
    """Launch stage 2: the leaf's trust ratio from stage 1's partials into
    ``r`` [1], and w -= lr * r * u in place."""
    n = w.numel()
    fn = _build.bind(_LIB, "lamb_stage2", 4, 2, 1)
    err = fn(w.data_ptr(), u.data_ptr(), partials.data_ptr(), r.data_ptr(),
             n, grid_blocks(n), lr, _stream(w))
    _build.check(err, "lamb_stage2")
    LAUNCHES["lamb_stage2"] += 1
