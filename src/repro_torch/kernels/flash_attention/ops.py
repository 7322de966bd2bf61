"""Wrapper for the flash-attention forward kernel
(``csrc/flash_attention.cu``).

Dispatch is on the tensors' device: CPU tensors take the plain PyTorch
version in ``ref.py``; CUDA tensors launch the hand-written sm_90a kernel or
raise (bf16 only, head dim 64 or 128). There is no fallback from one to the
other. ``LAUNCHES`` counts the kernel's launches (plain calls do not count).

Gradients: where autograd would record the call (grad mode on and q, k or
v requiring a gradient), the call is the autograd Function ``_FlashAttn``.
Its forward is the kernel (the plain version on the CPU) with each query
row's log-sum-exp written beside the output, and it saves q, k, v, kv_len,
the output and the lse; its backward is ``ref.flash_attention_bwd``, JAX's
chunked-attention backward in plain PyTorch over ``block_kv``-key tiles
(the JAX package's flash kernel has no VJP, so there is no backward kernel
to port). Without a gradient nothing is written but the output.

Layout is the model's, as ``repro.kernels.flash_attention.ops``: q [B, Sq,
Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]. The kernel reads q, k and v
in place by TMA through their strides (D contiguous), so k/v may be column
views of the fused QKV projection. ``block_kv`` is the plain version's key
tile; the kernel streams 128-key tiles for 128-query work items, and the
online softmax gives the same result for any tile (up to fp32 rounding).

The kernel's grid is persistent: one CTA per SM walks the work items
(query tile, batch, query head) in the order ``work_order`` builds here,
heaviest first. The order depends only on the shapes and masks, so it is
built once per distinct call and kept on the card.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ...core import optrace
from .. import _build
from .._grad import wants_grad
from . import ref

LAUNCHES = {"flash_attention": 0}

_LIB = "flash_attention"
HEAD_DIMS = (64, 128)
BQ = 128        # the kernel's query rows per work item
BK = 128        # and keys per tile


def key_tiles(q0: int, sq: int, sk: int, kvl: int, *, causal: bool,
              q_offset: int = 0, window: int = 0) -> tuple:
    """The key tiles [begin, end) that the kernel visits for the query tile
    starting at row ``q0`` with ``kvl`` valid keys (``key_tiles`` in
    ``csrc/flash_attention.cu``, the same rule): the union of the rows'
    bands, or every tile when a row's band is empty. The first and last
    rows decide, since rows with an empty band sit only at the ends."""
    p0, p1 = q0 + q_offset, min(q0 + BQ, sq) - 1 + q_offset

    def band(pos):
        hi = min(kvl, pos + 1) if causal else kvl
        lo = max(0, pos - window + 1) if window > 0 else 0
        return lo, hi
    (lo0, hi0), (lo1, hi1) = band(p0), band(p1)
    if lo0 >= hi0 or lo1 >= hi1:
        return 0, -(-sk // BK)
    return lo0 // BK, -(-hi1 // BK)


def work_order(b: int, hq: int, sq: int, sk: int, *, causal: bool,
               q_offset: int = 0, window: int = 0) -> np.ndarray:
    """The kernel's work items, each ``qtile * (B * Hq) + b * Hq + h``, in
    the order its persistent CTAs take them: query tiles by the key tiles
    the kernel visits for them with every key valid, most first (ties: the
    later tile first), each tile's batch rows in order, and within a row
    the Hq heads in order, so that the heads of one KV head are neighbours
    and read its K/V from L2. The valid lengths play no part: they live on
    the card, and reading them would make the host wait for it."""
    groups = []
    for qt in range(-(-sq // BQ)):
        lo, hi = key_tiles(qt * BQ, sq, sk, sk, causal=causal,
                           q_offset=q_offset, window=window)
        groups += [(-(hi - lo), -qt, bi) for bi in range(b)]
    groups.sort()
    nbh = b * hq
    return np.asarray([-nqt * nbh + bi * hq + h for _, nqt, bi in groups
                       for h in range(hq)], dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _order_on(device: torch.device, b, hq, sq, sk, causal, q_offset, window):
    return torch.as_tensor(work_order(b, hq, sq, sk, causal=causal,
                                      q_offset=q_offset, window=window),
                           device=device)


def _launch(q, k, v, kv_len, order, out, *, causal, q_offset, window,
            lse: Optional[torch.Tensor] = None, lib: str = _LIB) -> None:
    """One launch of ``flash_attention_fwd`` from the library ``lib`` under
    ``build/repro_torch/`` on tensors ``_check`` has passed: the one place
    that spells the kernel's C signature. ``lse`` (contiguous [B, Hq, Sq]
    fp32) receives the rows' log-sum-exp; None writes none. Counts
    nothing."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    fn = _build.bind(lib, "flash_attention_fwd", 7, 19, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             order.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), b, hq, hkv, sq, sk, d,
             int(q_offset), int(window), int(bool(causal)), order.numel(),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, lib)


def _check(q, k, v, kv_len):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash attention kernel is not supported for "
                        f"{q.dtype}/{k.dtype}/{v.dtype}: it takes bfloat16 "
                        "q, k and v")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D]: "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (Hq a multiple of Hkv, equal "
                         "batch and head dim)")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel is not supported for "
                         f"head dim {d}: it is built for {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head dim, strides "
                             "that are multiples of 8 elements and a 16-byte "
                             "aligned base (the kernel's TMA reads)")
        if max(t.stride()[:3]) >= 2 ** 31:
            raise ValueError(f"{name}'s strides do not fit the kernel's "
                             "32-bit stride arguments")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) \
            or kv_len.device != q.device or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be a contiguous int32 [{b}] tensor on "
                         f"{q.device}, got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")


def flash_attention_flops(q, k, v, *, causal: bool, q_offset: int = 0,
                          kv_len=None, window: int = 0,
                          block_kv: int = 512) -> float:
    """FLOPs of one call, as the plain version's ops count them
    (``core/characterize.py``), tile by tile of ``block_kv`` keys: the two
    products, the masks, the online softmax's updates; every masked entry
    is counted, as the plain version computes it."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    rows = b * hq * sq
    total = 2.0 * rows * d + sq + rows
    for j0 in range(0, sk, block_kv):
        n = min(block_kv, sk - j0)
        total += 4.0 * rows * d * n + n + b * n + 5.0 * rows * n \
            + 5.0 * rows + 2.0 * rows * d
        if causal:
            total += sq * n + b * sq * n
        if window > 0:
            total += sq + sq * n + b * sq * n
    return total


def _forward(q, k, v, kv_len, *, causal, q_offset, window, block_kv,
             with_lse: bool):
    """The forward on q's device: the plain version on the CPU, else one
    kernel launch (none for Sk 0) -> out, or (out, lse [B, Hq, Sq] fp32)
    with ``with_lse``."""
    b, sq, hq, d = q.shape
    if q.device.type == "cpu":
        res = ref.flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_len,
            causal=causal, q_offset=q_offset, window=window,
            block_kv=block_kv, return_lse=with_lse)
        if not with_lse:
            return res.transpose(1, 2)
        return res[0].transpose(1, 2), res[1]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, kv_len)
    sk = k.shape[1]
    lse = torch.empty((b, hq, sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if sk == 0:         # no key: the plain version's 0 / max(0, 1e-30)
        out = torch.zeros((b, sq, hq, d), dtype=q.dtype, device=q.device)
        if with_lse:
            lse.fill_(ref.NEG_INF)
            return out, lse
        return out
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    order = _order_on(q.device, b, hq, sq, sk, bool(causal), int(q_offset),
                      int(window))
    _launch(q, k, v, kv_len, order, out, causal=causal, q_offset=q_offset,
            window=window, lse=lse)
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


class _FlashAttn(torch.autograd.Function):
    """The forward kernel with its lse; JAX's chunked backward
    (``ref.flash_attention_bwd``) from what it saved."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal: bool, q_offset: int,
                window: int, block_kv: int):
        out, lse = _forward(q, k, v, kv_len, causal=causal,
                            q_offset=q_offset, window=window,
                            block_kv=block_kv, with_lse=True)
        ctx.save_for_backward(q, k, v, kv_len, out, lse)
        ctx.args = (causal, q_offset, window, block_kv)
        return out

    @staticmethod
    def backward(ctx, do):
        causal, q_offset, window, block_kv = ctx.args
        return ref.flash_attention_bwd(
            *ctx.saved_tensors, do, causal=causal, q_offset=q_offset,
            window=window, block_kv=block_kv) + (None,) * 5


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool,
                             q_offset: int = 0,
                             kv_len: Optional[torch.Tensor] = None,
                             window: int = 0, block_kv: int = 512):
    """``flash_attention``'s forward, recorded by no autograd, returning
    ``(out, lse)``: the output and each query row's log-sum-exp [B, Hq,
    Sq] fp32, as the training forward saves them."""
    with torch.no_grad():
        return _forward(q, k, v, _lengths(q, k, kv_len), causal=causal,
                        q_offset=q_offset, window=window, block_kv=block_kv,
                        with_lse=True)


def _lengths(q, k, kv_len):
    """kv_len as the forward takes it: int32 [B] on q's device (all Sk
    where None)."""
    if kv_len is None:
        return torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                          device=q.device)
    return kv_len if q.device.type == "cpu" else kv_len.to(torch.int32)


@optrace.kernel_op("flash_attention", flash_attention_flops)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None, window: int = 0,
                    block_kv: int = 512) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D] (model layout); kv_len [B]
    valid keys per batch row (None: all Sk) -> [B, Sq, Hq, D] in q's
    dtype. ``block_kv`` sets the plain version's key tile, and the
    backward's: the CUDA kernel always streams 128-key tiles. Where
    autograd would record the call, it is ``_FlashAttn`` (gradients to q,
    k and v)."""
    kv_len = _lengths(q, k, kv_len)
    if wants_grad(q, k, v):
        return _FlashAttn.apply(q, k, v, kv_len, bool(causal), int(q_offset),
                                int(window), int(block_kv))
    return _forward(q, k, v, kv_len, causal=causal, q_offset=q_offset,
                    window=window, block_kv=block_kv, with_lse=False)
