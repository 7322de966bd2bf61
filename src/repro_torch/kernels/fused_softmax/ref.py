"""Plain PyTorch version of the fused scale + causal mask + softmax: the CPU
path of ``ops.scale_mask_softmax`` and what ``chip_smoke.py`` holds the CUDA
kernel against. The operations of ``repro.kernels.fused_softmax.ref``, in
their order:

- ``x = s * scale`` in fp32;
- where causal, entries with ``col > row + q_offset`` take ``NEG_INF``, a
  finite -1e30 and not -inf: a row with no valid column (``q_offset < 0``)
  then comes out uniform, 1 / Sk, as the reference's does;
- the row max, ``exp(x - m)``, ``p / sum(p)``, and a cast back to
  ``s.dtype``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def scale_mask_softmax(s: torch.Tensor, *, scale: float, causal: bool,
                       q_offset: int = 0) -> torch.Tensor:
    """s [..., Sq, Sk] raw scores -> softmax(scale * s + causal mask) over
    the last axis, fp32 statistics, in s's dtype."""
    x = s.float() * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(sq, device=s.device)[:, None] + q_offset
        cols = torch.arange(sk, device=s.device)[None, :]
        x = torch.where(cols <= rows, x, NEG_INF)
    m = x.amax(dim=-1, keepdim=True)
    p = torch.exp(x - m)
    return (p / p.sum(dim=-1, keepdim=True)).to(s.dtype)
