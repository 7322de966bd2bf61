"""Plain PyTorch versions of the paged attention kernels: gather the K/V
pages through the page table into a dense layout and run
``models.attention.naive_attention``. The CPU path of the wrappers in
``ops.py``, and what ``chip_smoke.py`` holds the CUDA kernels against.
Counterpart of ``repro.kernels.decode_attention.ref``."""
from __future__ import annotations

import torch

from ...models.attention import naive_attention


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_row: torch.Tensor,
                            start: int, total_len: int) -> torch.Tensor:
    """q [C, Hq, D] (row i at position start + i; the chunk's own K/V is
    already in the pages); page_row [max_pages] -> [C, Hq, D]. Causal from
    ``start``, clipped at ``total_len``; padding rows are garbage."""
    _, hq, d = q.shape
    hkv = k_pages.shape[2]
    rows = page_row.long()
    k = k_pages[rows].reshape(1, -1, hkv, d)
    v = v_pages[rows].reshape(1, -1, hkv, d)
    kv_len = torch.tensor([int(total_len)], dtype=torch.int64)
    return naive_attention(q[None], k, v, causal=True, q_offset=int(start),
                           kv_len=kv_len)[0]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           seq_lens: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D]; pools [P, page, Hkv, D]; page_table [B, max_pages];
    seq_lens [B] valid cache lengths -> [B, Hq, D]. Rows with seq_len 0 get
    a uniform average here (the kernel returns zeros); the engine never
    reads them."""
    b, hq, d = q.shape
    hkv = k_pages.shape[2]
    table = page_table.long()
    k = k_pages[table].reshape(b, -1, hkv, d)
    v = v_pages[table].reshape(b, -1, hkv, d)
    return naive_attention(q[:, None], k, v, causal=False,
                           kv_len=seq_lens.long())[:, 0]
