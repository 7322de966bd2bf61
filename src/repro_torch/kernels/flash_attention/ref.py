"""Plain PyTorch version of the flash-attention forward: the CPU path of
``ops.flash_attention`` and what ``chip_smoke.py`` holds the CUDA kernel
against. It computes what the Pallas kernel
``repro.kernels.flash_attention.kernel.flash_attention_fwd`` computes:

- q is taken to fp32 and scaled by D^-0.5 before its product with K;
- an online softmax over ``block_kv``-key tiles, entirely in fp32, with
  p V in fp32 (p is not rounded to the model dtype, as the chunked path
  rounds it);
- masks ``cols < kv_len``, causal ``cols <= row + q_offset`` and, for a
  window, ``cols > row + q_offset - window``; a masked score is the finite
  -1e30, so a row with no valid key returns the mean of V over all Sk keys;
- GQA by grouping the query heads of one KV head (K/V are not repeated).

Unlike the Pallas kernel it takes any Sq and Sk: the last tile is shorter.
With ``return_lse`` it also returns each query row's log-sum-exp, as the
kernel writes it for the backward.

``flash_attention_bwd`` is the backward of ``ops.flash_attention``: the
JAX package has no backward kernel (its flash kernel has no VJP at all), so
the port's backward is plain PyTorch, JAX's chunked-attention backward
(``models.attention.tiled_attention_bwd``, the oracle JAX's ``ref.py``
imports from its ``models/attention.py`` too) over ``block_kv``-key tiles.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...models.attention import empty_rows, tiled_attention_bwd

NEG_INF = -1e30


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: torch.Tensor, *, causal: bool,
                        q_offset: int = 0, window: int = 0,
                        block_kv: int = 512, return_lse: bool = False):
    """q [B, Hq, Sq, D]; k/v [B, Hkv, Sk, D]; kv_len [B] -> [B, Hq, Sq, D]
    in q's dtype; with ``return_lse`` also the rows' log-sum-exp m + log l
    [B, Hq, Sq] fp32 (NEG_INF for a row with no valid key)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    # the G query heads of a KV head share its K/V: [B, Hkv, G * Sq, D]
    qf = (q.float() * (1.0 / d ** 0.5)).reshape(b, hkv, g * sq, d)
    rows = torch.arange(sq, device=dev)[:, None] + q_offset      # [Sq, 1]
    lens = kv_len.to(dev).long()[:, None, None, None, None]      # [B,1,1,1,1]
    o = torch.zeros((b, hkv, g * sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g * sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, g * sq), dtype=torch.float32, device=dev)
    for j0 in range(0, sk, block_kv):
        kj = k[:, :, j0:j0 + block_kv].float()
        vj = v[:, :, j0:j0 + block_kv].float()
        n = kj.shape[2]
        s = (qf @ kj.transpose(-1, -2)).reshape(b, hkv, g, sq, n)
        cols = j0 + torch.arange(n, device=dev)[None, :]          # [1, n]
        mask = cols[None, None, None] < lens                      # [B,1,1,1,n]
        if causal:
            mask = mask & (cols <= rows)
        if window > 0:
            mask = mask & (cols > rows - window)
        s = torch.where(mask, s, NEG_INF).reshape(b, hkv, g * sq, n)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + p @ vj
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    o = (o / l[..., None]).reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(l)).reshape(b, hq, sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool,
                        q_offset: int = 0, window: int = 0,
                        block_kv: int = 512
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of the flash forward in the model layout: q [B, Sq, Hq,
    D], k/v [B, Sk, Hkv, D], kv_len [B], the forward's output ``out`` [B,
    Sq, Hq, D] and ``lse`` [B, Hq, Sq], the output's gradient ``do`` ->
    (dq, dk, dv) in the inputs' dtypes. K/V are not padded: the last key
    tile keeps its true width. Rows with no valid key take autodiff's
    gradient of the forward (V averaged over all Sk keys; none to q or k)."""
    empty = empty_rows(q.shape[1], kv_len, causal=causal, q_offset=q_offset,
                       window=window)
    return tiled_attention_bwd(q, k, v, kv_len, out, lse, do, causal=causal,
                               chunk=block_kv, q_offset=q_offset,
                               window=window, empty=empty)
