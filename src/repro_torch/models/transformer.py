"""Layer stacks of the paged serving path. Counterpart of the paged part of
``repro.models.transformer``: the dense family has a period of one layer,
so the JAX ``lax.scan`` over stacked periods becomes a Python loop over the
per-layer parameter dicts in ``params["blocks"]``. Page pools are updated
in place (see ``models.attention``), so the stacks return only activations.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from ..configs.base import ArchConfig
from . import attention as attn_lib
from .layers import Params, apply_mlp, apply_norm


def init_serving_state(arch: ArchConfig, num_pages: int, page_size: int,
                       dtype: torch.dtype, device) -> List[Params]:
    """One paged KV pool ``{k, v}: [P, page, Hkv, Dh]`` per layer. Every
    layer shares one logical page table: a sequence's page ids index the
    same rows of every layer's pool."""
    if arch.family != "dense":
        raise NotImplementedError(
            f"family {arch.family!r}: the port serves the dense family only")
    return [attn_lib.init_paged_kv_cache(arch, num_pages, page_size, dtype,
                                         device)
            for _ in range(arch.num_layers)]


def _decode_block_mix(arch: ArchConfig, blk: Params, x: torch.Tensor,
                      mix_fn: Callable[[torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """Pre-norm residual wrapping of a mixer ``mix_fn(h) -> y``."""
    return x + mix_fn(apply_norm(arch.norm, blk["ln1"], x))


def _decode_block_ffn(arch: ArchConfig, blk: Params,
                      x: torch.Tensor) -> torch.Tensor:
    """Pre-norm MLP tail of a block with its residual add."""
    return x + apply_mlp(arch.mlp, blk["mlp"],
                         apply_norm(arch.norm, blk["ln2"], x))


def paged_decode_period(arch: ArchConfig, blk: Params, cache: Params,
                        x: torch.Tensor, page_table: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """One layer of single-token decode (the unfused period body)."""
    def mix(h):
        return attn_lib.paged_decode_attention_layer(
            arch, blk["attn"], h, cache, page_table, seq_lens)
    x = _decode_block_mix(arch, blk, x, mix)
    return _decode_block_ffn(arch, blk, x)


def paged_decode_stack(arch: ArchConfig, blocks: List[Params],
                       caches: List[Params], x: torch.Tensor,
                       page_table: torch.Tensor,
                       seq_lens: torch.Tensor) -> torch.Tensor:
    """Single-token decode x [B, 1, D] through every layer."""
    for blk, cache in zip(blocks, caches):
        x = paged_decode_period(arch, blk, cache, x, page_table, seq_lens)
    return x


def paged_prefill_period(arch: ArchConfig, blk: Params, cache: Params,
                         x: torch.Tensor, page_row: torch.Tensor, start: int,
                         total_len: int) -> torch.Tensor:
    def mix(h):
        return attn_lib.paged_prefill_attention_layer(
            arch, blk["attn"], h, cache, page_row, start, total_len)
    x = _decode_block_mix(arch, blk, x, mix)
    return _decode_block_ffn(arch, blk, x)


def paged_prefill_stack(arch: ArchConfig, blocks: List[Params],
                        caches: List[Params], x: torch.Tensor,
                        page_row: torch.Tensor, start: int,
                        total_len: int) -> torch.Tensor:
    """Chunked prefill: one prompt chunk x [1, C, D] of one sequence through
    every layer, its K/V written straight into the sequence's pages."""
    for blk, cache in zip(blocks, caches):
        x = paged_prefill_period(arch, blk, cache, x, page_row, start,
                                 total_len)
    return x


def chunk_final_hidden(x: torch.Tensor, start: int,
                       total_len: int) -> torch.Tensor:
    """[B, C, D] chunk activations -> [B, 1, D] of the chunk's last valid
    token (position ``total_len - 1``): the final chunk's logits surface."""
    i = total_len - 1 - start
    return x[:, i:i + 1]
