"""Wrapper for the flash-attention forward kernel
(``csrc/flash_attention.cu``).

Dispatch is on the tensors' device: CPU tensors take the plain PyTorch
version in ``ref.py``; CUDA tensors launch the hand-written sm_90a kernel or
raise (bf16 only, head dim 64 or 128). There is no fallback from one to the
other. ``LAUNCHES`` counts the kernel's launches (plain calls do not count).

Layout is the model's, as ``repro.kernels.flash_attention.ops``: q [B, Sq,
Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]. The kernel reads q, k and v
in place through their strides (D contiguous), so k/v may be column views of
the fused QKV projection. ``block_kv`` is the plain version's key tile; the
kernel streams 64-key tiles, and the online softmax gives the same result
for any tile (up to fp32 rounding).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import ref

LAUNCHES = {"flash_attention": 0}

_LIB = "flash_attention"
HEAD_DIMS = (64, 128)


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
                             "aligned base (the kernel reads 16-byte rows)")
        if max(t.stride()[:3]) >= 2 ** 31:
            raise ValueError(f"{name}'s strides do not fit the kernel's "
                             "32-bit stride arguments")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) \
            or kv_len.device != q.device or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be a contiguous int32 [{b}] tensor on "
                         f"{q.device}, got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None, window: int = 0,
                    block_kv: int = 512) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D] (model layout); kv_len [B]
    valid keys per batch row (None: all Sk) -> [B, Sq, Hq, D] in q's
    dtype. ``block_kv`` sets the plain version's key tile only: the CUDA
    kernel always streams 64-key tiles."""
    b = q.shape[0]
    if kv_len is None:
        kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=q.device)
    if q.device.type == "cpu":
        return ref.flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_len,
            causal=causal, q_offset=q_offset, window=window,
            block_kv=block_kv).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention kernel has no backward in repro_torch yet "
            "(training with attn_impl='flash' is not ported)")
    kv_len = kv_len.to(torch.int32)
    _check(q, k, v, kv_len)
    _, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    fn = _build.bind(_LIB, "flash_attention_fwd", 5, 18, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             out.data_ptr(), b, hq, hkv, sq, sk, d, int(q_offset),
             int(window), int(bool(causal)), *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], 1.0 / d ** 0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
