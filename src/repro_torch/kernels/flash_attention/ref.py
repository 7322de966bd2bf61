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
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: torch.Tensor, *, causal: bool,
                        q_offset: int = 0, window: int = 0,
                        block_kv: int = 512) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k/v [B, Hkv, Sk, D]; kv_len [B] -> [B, Hq, Sq, D]
    in q's dtype."""
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
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(b, hq, sq, d).to(q.dtype)
