"""Layer stacks: the training path's full-sequence blocks, the static
engine's dense-cache path (``init_caches``, ``decode_stack``) and the
continuous engine's paged serving path. Counterpart of
``repro.models.transformer``: the JAX ``lax.scan`` over stacked periods
becomes a Python loop over the per-layer parameter dicts in
``params["blocks"]``, the periods flattened (layer ``l`` has the mixer kind
``layer_kinds(arch)[l % period_length(arch)]``; dense and ssm have a period
of one layer). Caches, page pools and mamba slot state are updated in place
(see ``models.attention`` and ``models.ssm``), so the stacks return only
activations.

Training blocks (``apply_block``, ``apply_stack``): pre-norm, or BERT's
post-norm. ``fused`` (None = ``REPRO_FUSED_BLOCKS``, default off) routes the
post-norm residual add + norm sites through ``fused_residual_layernorm`` and
the gelu MLP's bias + activation through ``bias_gelu``: a tolerance contract
with the unfused block (an fp32 add where the unfused one adds in the model
dtype), not a bitwise one. ``arch.remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``), as JAX's per-block
``jax.checkpoint(policy=nothing_saveable)`` does.

The serving layer bodies (both engines) are pre-norm, or post-norm where
``arch.post_norm`` (BERT: the norm after the residual add), as JAX's.
``fused=True`` runs the fused decode layer body, pre-norm only: the
residual stream rides as an ``(x, pending delta)`` pair, the add + norm at
ln2 is one ``decode_residual_norm`` kernel, and the MLP delta is folded by
a plain add at the layer's end. On the CPU the kernel's plain version is the unfused
add and norm, so both bodies give the same bits there.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig
from ..kernels.fused_layernorm import ops as ln_ops
from . import attention as attn_lib
from . import ssm as ssm_lib
from .layers import Params, apply_mlp, apply_norm


def fused_blocks_enabled() -> bool:
    """Training block fusion (``fused_residual_layernorm`` + ``bias_gelu``):
    ``REPRO_FUSED_BLOCKS=1`` turns it on; off by default, as in JAX."""
    return os.environ.get("REPRO_FUSED_BLOCKS", "0") == "1"


def apply_block(arch: ArchConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, causal: bool,
                fused: Optional[bool] = None) -> torch.Tensor:
    """One pre-norm (or BERT post-norm) attention block over x [B, S, D].
    The dense family has no auxiliary loss (JAX's is 0 for it), so only the
    activations are returned."""
    if fused is None:
        fused = fused_blocks_enabled()
    if arch.family != "dense":
        raise NotImplementedError(
            f"family {arch.family!r}: the port trains the dense family only")

    def mix(h):
        return attn_lib.apply_attention(arch, p["attn"], h, positions,
                                        causal=causal)

    def add_norm(ln: Params, y: torch.Tensor, res: torch.Tensor):
        if fused:
            return ln_ops.fused_residual_layernorm(
                y, res, ln["scale"], ln.get("bias"),
                rms=arch.norm == "rmsnorm")
        return apply_norm(arch.norm, ln, res + y)

    if arch.post_norm:
        x = add_norm(p["ln1"], mix(x), x)
        return add_norm(p["ln2"], apply_mlp(arch.mlp, p["mlp"], x,
                                            fused=fused), x)
    if fused:
        raise NotImplementedError(
            "the fused pre-norm training block (decode_residual_norm with a "
            "gradient) is not ported")
    x = x + mix(apply_norm(arch.norm, p["ln1"], x))
    return x + apply_mlp(arch.mlp, p["mlp"],
                         apply_norm(arch.norm, p["ln2"], x))


def apply_stack(arch: ArchConfig, blocks: List[Params], x: torch.Tensor,
                positions: torch.Tensor, causal: bool,
                fused: Optional[bool] = None) -> torch.Tensor:
    """Every block in turn; with ``arch.remat`` each block is recomputed in
    the backward pass, so only its [B, S, D] input stays alive."""
    if fused is None:
        fused = fused_blocks_enabled()
    blk = functools.partial(apply_block, arch, positions=positions,
                            causal=causal, fused=fused)
    for p in blocks:
        if arch.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(blk, p, x,
                                                  use_reentrant=False)
        else:
            x = blk(p, x)
    return x


def period_length(arch: ArchConfig) -> int:
    """Layers in the smallest repeating group of the stack (a hybrid
    stack's period; 1 for dense and ssm, the families the port serves)."""
    return arch.hybrid_period if arch.family == "hybrid" else 1


def layer_kinds(arch: ArchConfig) -> Tuple[str, ...]:
    """The mixer kind of each layer within one period: "attn" or
    "mamba". Layer ``l`` of the flattened stack has kind
    ``layer_kinds(arch)[l % period_length(arch)]``."""
    return tuple("attn" if arch.is_attention_layer(i) else "mamba"
                 for i in range(period_length(arch)))


def _stack_kinds(arch: ArchConfig) -> List[str]:
    kinds = layer_kinds(arch)
    return [kinds[i % len(kinds)] for i in range(arch.num_layers)]


def init_serving_state(arch: ArchConfig, num_pages: int, page_size: int,
                       num_slots: int, dtype: torch.dtype,
                       device) -> List[Params]:
    """Per-layer decode state of the continuous engine, one entry per layer
    of the flattened stack; each layer kind declares its own:

    - ``attn``: a paged KV pool ``{k, v}: [P, page, Hkv, Dh]``. Every
      attention layer shares one logical page table: a sequence's page ids
      index the same rows of every layer's pool.
    - ``mamba``: a pooled, constant-size per-slot state ``{conv: [slot,
      W-1, C], state: [slot, H, N, P]}`` (``ssm.init_mamba_cache``): the
      recurrence folds all history into fixed size, so it rides the decode
      slot, not pages.
    """
    def layer_state(kind):
        if kind == "attn":
            return attn_lib.init_paged_kv_cache(arch, num_pages, page_size,
                                                dtype, device)
        return ssm_lib.init_mamba_cache(arch, num_slots, dtype, device)
    return [layer_state(k) for k in _stack_kinds(arch)]


def _decode_block_mix(arch: ArchConfig, blk: Params, x: torch.Tensor,
                      mix_fn: Callable[[torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """Pre- or post-norm residual wrapping of a mixer ``mix_fn(h) -> y``:
    post-norm (BERT) feeds the mixer the raw stream and norms after the
    residual add."""
    h = x if arch.post_norm else apply_norm(arch.norm, blk["ln1"], x)
    y = mix_fn(h)
    return apply_norm(arch.norm, blk["ln1"], x + y) if arch.post_norm \
        else x + y


def _decode_block_ffn(arch: ArchConfig, blk: Params,
                      x: torch.Tensor) -> torch.Tensor:
    """Pre- or post-norm MLP tail of a block with its residual add (none for
    a block without ln2: mamba2's have no MLP)."""
    if "ln2" not in blk:
        return x
    h = x if arch.post_norm else apply_norm(arch.norm, blk["ln2"], x)
    y = apply_mlp(arch.mlp, blk["mlp"], h)
    return apply_norm(arch.norm, blk["ln2"], x + y) if arch.post_norm \
        else x + y


def _fused_residual_norm(arch: ArchConfig, ln: Params, d: torch.Tensor,
                         x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the pending residual delta ``d`` into the stream and norm it in
    one kernel: ``x += d; h = norm(x)`` -> ``(h, x_new)``."""
    return ln_ops.decode_residual_norm(d, x, ln["scale"], ln.get("bias"),
                                       kind=arch.norm)


def _fused_block_delta(arch: ArchConfig, blk: Params,
                       h: torch.Tensor) -> torch.Tensor:
    """MLP tail of a fused block: the residual *delta*, whose add is
    deferred to the layer's end."""
    return apply_mlp(arch.mlp, blk["mlp"], h)


def _period(arch: ArchConfig, blk: Params, x: torch.Tensor,
            mix: Callable[[torch.Tensor], torch.Tensor],
            fused: bool) -> torch.Tensor:
    """One layer around the mixer ``mix``: unfused, or the fused body (ln1
    norm, mixer, fused add + ln2 norm, MLP delta, boundary add). A mamba2
    block has no ln2 and no MLP: its fused body's pending delta is the
    mixer output itself, folded by the boundary add, so with a period of
    one layer fused and unfused are the same operations and no
    ``decode_residual_norm`` runs (fused decode changes only the head).
    The fused body is pre-norm only, as JAX's."""
    if fused:
        assert not arch.post_norm, (arch.name, "fused decode is pre-norm only")
    if not fused or "ln2" not in blk:
        x = _decode_block_mix(arch, blk, x, mix)
        return _decode_block_ffn(arch, blk, x)
    h = apply_norm(arch.norm, blk["ln1"], x)
    h2, x = _fused_residual_norm(arch, blk["ln2"], mix(h), x)
    return x + _fused_block_delta(arch, blk, h2)


def paged_decode_period(arch: ArchConfig, blk: Params, cache: Params,
                        x: torch.Tensor, page_table: torch.Tensor,
                        seq_lens: torch.Tensor, active: torch.Tensor,
                        kind: str = "attn",
                        fused: bool = False) -> torch.Tensor:
    """One layer of single-token decode, dispatched on its mixer ``kind``.
    ``active`` [S] (``seq_lens > 0``) guards a mamba layer's state rows:
    attention routes an idle slot's write to the null page instead."""
    def mix(h):
        if kind == "attn":
            return attn_lib.paged_decode_attention_layer(
                arch, blk["attn"], h, cache, page_table, seq_lens)
        return ssm_lib.paged_decode_mamba_layer(arch, blk["mamba"], h, cache,
                                                active)
    return _period(arch, blk, x, mix, fused)


def paged_decode_stack(arch: ArchConfig, blocks: List[Params],
                       caches: List[Params], x: torch.Tensor,
                       page_table: torch.Tensor, seq_lens: torch.Tensor,
                       fused: bool = False) -> torch.Tensor:
    """Single-token decode x [B, 1, D] through every layer. A slot with
    seq_len 0 is empty or mid-prefill: its state is left as it was."""
    active = seq_lens > 0
    for blk, cache, kind in zip(blocks, caches, _stack_kinds(arch)):
        x = paged_decode_period(arch, blk, cache, x, page_table, seq_lens,
                                active, kind, fused)
    return x


def paged_prefill_period(arch: ArchConfig, blk: Params, cache: Params,
                         x: torch.Tensor, page_row: torch.Tensor, start: int,
                         total_len: int, slot: int = 0, kind: str = "attn",
                         fused: bool = False) -> torch.Tensor:
    """One layer of one prompt chunk, dispatched on its mixer ``kind``:
    attention writes K/V into the sequence's pages, mamba advances the
    state in the sequence's ``slot`` row."""
    def mix(h):
        if kind == "attn":
            return attn_lib.paged_prefill_attention_layer(
                arch, blk["attn"], h, cache, page_row, start, total_len)
        return ssm_lib.paged_prefill_mamba_layer(arch, blk["mamba"], h,
                                                 cache, slot, start,
                                                 total_len)
    return _period(arch, blk, x, mix, fused)


def paged_prefill_stack(arch: ArchConfig, blocks: List[Params],
                        caches: List[Params], x: torch.Tensor,
                        page_row: torch.Tensor, start: int,
                        total_len: int, slot: int = 0,
                        fused: bool = False) -> torch.Tensor:
    """Chunked prefill: one prompt chunk x [1, C, D] of one sequence through
    every layer, its K/V written straight into the sequence's pages and
    its mamba state into its slot's rows."""
    for blk, cache, kind in zip(blocks, caches, _stack_kinds(arch)):
        x = paged_prefill_period(arch, blk, cache, x, page_row, start,
                                 total_len, slot, kind, fused)
    return x


def init_caches(arch: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype, device) -> List[Params]:
    """The static engine's decode caches, one entry per layer of the
    flattened stack: ``attn`` layers a dense ``{k, v}: [B, max_len, Hkv,
    Dh]`` cache, ``mamba`` layers ``{conv: [B, W-1, C], state: [B, H, N,
    P]}``. Both are updated in place."""
    if arch.family == "encdec":
        raise NotImplementedError(
            "whisper's cross-attention KV cache is not ported to "
            "repro_torch yet")

    def layer_cache(kind):
        if kind == "attn":
            return attn_lib.init_kv_cache(arch, batch, max_len, dtype, device)
        return ssm_lib.init_mamba_cache(arch, batch, dtype, device)
    return [layer_cache(k) for k in _stack_kinds(arch)]


def decode_period(arch: ArchConfig, blk: Params, cache: Params,
                  x: torch.Tensor, positions: torch.Tensor,
                  kind: str = "attn") -> torch.Tensor:
    """One layer of the static engine over S new tokens x [B, S, D] (S > 1
    prefill, S == 1 decode) at cache rows ``positions`` [B], dispatched on
    its mixer ``kind``; the layer's cache is updated in place."""
    def mix(h):
        if kind == "attn":
            return attn_lib.extend_attention(arch, blk["attn"], h, cache,
                                             positions)
        y, new = ssm_lib.extend_mamba(arch, blk["mamba"], h, cache)
        cache["conv"].copy_(new["conv"])
        cache["state"].copy_(new["state"])
        return y
    x = _decode_block_mix(arch, blk, x, mix)
    return _decode_block_ffn(arch, blk, x)


def decode_stack(arch: ArchConfig, blocks: List[Params],
                 caches: List[Params], x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Every layer of the static engine in turn (prefill or one decode
    step); returns the activations, the caches are updated in place."""
    for blk, cache, kind in zip(blocks, caches, _stack_kinds(arch)):
        x = decode_period(arch, blk, cache, x, positions, kind)
    return x


def chunk_final_hidden(x: torch.Tensor, start: int,
                       total_len: int) -> torch.Tensor:
    """[B, C, D] chunk activations -> [B, 1, D] of the chunk's last valid
    token (position ``total_len - 1``): the final chunk's logits surface."""
    i = total_len - 1 - start
    return x[:, i:i + 1]
