"""Wrapper of the fused LAMB kernels (``csrc/fused_lamb.cu``): one leaf's
Fig. 3 update, in place.

CPU tensors take the plain version (``ref.lamb_stage1``, then
``ref.trust_ratio`` and ``ref.lamb_stage2``) and copy its results into
``w``, ``m`` and ``v``; CUDA tensors launch the two hand-written sm_90a
kernels or raise. ``LAUNCHES`` counts kernel launches. ``stage1`` and
``stage2`` are one op each of an ``optrace`` trace, with the FLOPs
``stage1_flops`` and ``stage2_flops`` state.
Nothing here reads a device value on the host: ``ginv``, ``c1`` and ``c2``
arrive as a 3-float device tensor, and stage 2 reduces stage 1's per-block
partial norms itself, so a step of many leaves never waits on the card.
"""
from __future__ import annotations

import torch

from ...core import optrace
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
        u = torch.empty_like(w)
        r = torch.empty(1, dtype=torch.float32)
        stage1(w, g, m, v, scalars, u, None, beta1=beta1, beta2=beta2,
               eps=eps, weight_decay=weight_decay)
        stage2(w, u, None, r, lr=lr)
        return r
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


def stage1_flops(w, *args, **kwargs) -> float:
    """FLOPs of one stage-1 call, as its plain version's ops count them
    (``core/characterize.py``): 15 elementwise ops an element."""
    return 15.0 * w.numel()


def stage2_flops(w, *args, **kwargs) -> float:
    """FLOPs of one stage-2 call: the two squared norms (4 an element),
    the update (2 an element) and 9 scalar ops for the ratio."""
    return 6.0 * w.numel() + 9.0


@optrace.kernel_op("lamb_stage1", stage1_flops)
def stage1(w, g, m, v, scalars, u, partials, *, beta1: float, beta2: float,
           eps: float, weight_decay: float) -> None:
    """Stage 1 on checked tensors (``lamb_update_`` checks): m, v in place,
    u written; on the card also ``partials`` [2 * grid_blocks(n)], on the
    CPU (the plain version) ``partials`` is None."""
    if w.device.type == "cpu":
        m_new, v_new, u_new = ref.lamb_stage1(
            w, g, m, v, ginv=scalars[0], c1=scalars[1], c2=scalars[2],
            beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
        m.copy_(m_new)
        v.copy_(v_new)
        u.copy_(u_new)
        return
    n = w.numel()
    fn = _build.bind(_LIB, "lamb_stage1", 7, 3, 6)
    err = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
             scalars.data_ptr(), u.data_ptr(), partials.data_ptr(), n,
             grid_blocks(n), int(g.dtype == torch.float32), beta1,
             1.0 - beta1, beta2, 1.0 - beta2, eps, weight_decay, _stream(w))
    _build.check(err, "lamb_stage1")
    LAUNCHES["lamb_stage1"] += 1


@optrace.kernel_op("lamb_stage2", stage2_flops)
def stage2(w, u, partials, r, *, lr: float) -> None:
    """Stage 2: the leaf's trust ratio into ``r`` [1] (on the card from
    stage 1's partials), and w -= lr * r * u in place."""
    if w.device.type == "cpu":
        ratio = ref.trust_ratio(w, u)
        w.copy_(ref.lamb_stage2(w, u, lr=lr, r=ratio))
        r.copy_(ratio.reshape(1))
        return
    n = w.numel()
    fn = _build.bind(_LIB, "lamb_stage2", 4, 2, 1)
    err = fn(w.data_ptr(), u.data_ptr(), partials.data_ptr(), r.data_ptr(),
             n, grid_blocks(n), lr, _stream(w))
    _build.check(err, "lamb_stage2")
    LAUNCHES["lamb_stage2"] += 1
