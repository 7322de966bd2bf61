"""Layer stacks: the training path's full-sequence blocks, the static
engine's dense-cache path (``init_caches``, ``decode_stack``) and the
continuous engine's paged serving path. Counterpart of
``repro.models.transformer``: the JAX ``lax.scan`` over stacked periods
becomes a Python loop over the per-layer parameter dicts in
``params["blocks"]``, the periods flattened (layer ``l`` has the mixer kind
``layer_kinds(arch)[l % period_length(arch)]``; dense, moe and ssm have a
period of one layer, jamba one of 8). A block holds ``moe`` in place of
``mlp`` where ``arch.is_moe_layer(l)``; its tail is ``models.moe.apply_moe``
with each batch row routed on its own (a decode step's slots are rows of
one token, as in JAX), the Switch loss left out on the serving paths.
Caches, page pools and mamba slot state are updated in place (see
``models.attention`` and ``models.ssm``), so the serving stacks return
only activations.

Training blocks (``apply_block``, ``apply_stack``): pre-norm, or BERT's
post-norm; attention or mamba mixers, MLP or MoE tails, each block
returning its MoE's Switch loss beside the activations; qwen2-vl's M-RoPE
positions (``mrope_positions``) and, in a whisper decoder block, a
cross-attention sublayer (``ln_x``, ``xattn``) over the encoder output
``enc_out`` between the mixer and the MLP. The static engine's decoder
blocks read the encoder's K/V from the layer cache (``cross_k``,
``cross_v``), filled once a prefill. ``fused`` (None =
``REPRO_FUSED_BLOCKS``, default off) routes the
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
from ..core import optrace
from ..kernels.fused_layernorm import ops as ln_ops
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import Params, apply_mlp, apply_norm


def fused_blocks_enabled() -> bool:
    """Training block fusion (``fused_residual_layernorm`` + ``bias_gelu``):
    ``REPRO_FUSED_BLOCKS=1`` turns it on; off by default, as in JAX."""
    return os.environ.get("REPRO_FUSED_BLOCKS", "0") == "1"


def _ffn(arch: ArchConfig, p: Params, h: torch.Tensor, *,
         fused: bool = False, moe_cap: Optional[int] = None,
         group=None) -> torch.Tensor:
    """A block's MLP, or its MoE where it holds one (the Switch loss left
    out; ``moe_cap`` tightens the MoE's capacity); under serving tensor
    parallelism (``group``) the Megatron MLP or the expert-parallel MoE,
    each with its one reduce."""
    if "moe" in p:
        return moe_lib.apply_moe(arch, p["moe"], h, moe_cap,
                                 aux_loss=False, group=group)[0]
    return apply_mlp(arch.mlp, p["mlp"], h, fused=fused, group=group)


def apply_block(arch: ArchConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, causal: bool,
                fused: Optional[bool] = None,
                mixer: str = "attn",
                mrope_positions: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None, data_group=None,
                par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm (or BERT post-norm) block over x [B, S, D], its mixer
    attention or mamba, its tail an MLP or a MoE (none for mamba2); a
    block with ``xattn`` given ``enc_out`` [B, Senc, D] attends to it
    after the mixer. Returns ``(x, aux)``: ``aux`` is the MoE's Switch
    loss (fp32 scalar; 0 for any other tail), as JAX's ``apply_block``;
    with a ``data_group`` the whole data-parallel batch's.

    ``fused`` (None = ``REPRO_FUSED_BLOCKS``) routes the post-norm add +
    norm sites through ``fused_residual_layernorm``, the gelu MLP's bias +
    activation through ``bias_gelu`` and, in a pre-norm block, the mixer's
    residual add + ln2 through ``decode_residual_norm`` (JAX's
    ``fuse_pre_ln2``): not for a mamba2 block (it has no ln2) nor where a
    cross-attention sits between the two sites.

    On a training mesh (``par``, a ``parallel.collectives.Parallel``) the
    block first gathers its FSDP slices (so a recomputed block gathers
    again); x is then the residual stream as the mesh holds it (a rank's
    rows under sequence parallelism), the norms and residual adds run on
    it, and the attention or mamba mixer, the cross-attention and the MLP
    or MoE are the rank's tensor- or expert-parallel share (``enc_out``
    then the whole encoder sequence, as ``model.forward`` passes it)."""
    if fused is None:
        fused = fused_blocks_enabled()
    if par is not None:
        p = par.gather_params(p)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def mix(h):
        if mixer == "mamba":
            return ssm_lib.apply_mamba(arch, p["mamba"], h, par)
        return attn_lib.apply_attention(arch, p["attn"], h, positions,
                                        causal=causal,
                                        mrope_positions=mrope_positions,
                                        par=par)

    def add_norm(ln: Params, y: torch.Tensor, res: torch.Tensor):
        if fused:
            return ln_ops.fused_residual_layernorm(
                y, res, ln["scale"], ln.get("bias"),
                rms=arch.norm == "rmsnorm")
        return apply_norm(arch.norm, ln, res + y)

    def tail(h):
        if "moe" in p:
            return moe_lib.apply_moe(arch, p["moe"], h,
                                     data_group=data_group, par=par)
        return apply_mlp(arch.mlp, p["mlp"], h, fused=fused, par=par), aux

    cross = enc_out is not None and "xattn" in p
    h = None
    if arch.post_norm:
        x = add_norm(p["ln1"], mix(x), x)
    elif fused and "ln2" in p and not cross:
        h, x = ln_ops.decode_residual_norm(
            mix(apply_norm(arch.norm, p["ln1"], x)), x, p["ln2"]["scale"],
            p["ln2"].get("bias"), kind=arch.norm)
    else:
        x = x + mix(apply_norm(arch.norm, p["ln1"], x))
    if cross:
        x = x + _cross(arch, p, x, attn_lib.project_enc_kv(
            arch, p["xattn"], enc_out, par), par)
    if "ln2" not in p:                  # mamba2 blocks have no MLP
        return x, aux
    if arch.post_norm:
        y, aux = tail(x)
        return add_norm(p["ln2"], y, x), aux
    y, aux = tail(apply_norm(arch.norm, p["ln2"], x) if h is None else h)
    return x + y, aux


def _cross(arch: ArchConfig, p: Params, x: torch.Tensor,
           enc_kv: Tuple[torch.Tensor, torch.Tensor], par=None
           ) -> torch.Tensor:
    """A decoder block's cross-attention delta: ``ln_x`` then attention
    to the encoder's K/V (the rank's heads on a training mesh, ``par``)."""
    return attn_lib.apply_cross_attention(
        arch, p["xattn"], apply_norm(arch.norm, p["ln_x"], x), enc_kv, par)


def apply_stack(arch: ArchConfig, blocks: List[Params], x: torch.Tensor,
                positions: torch.Tensor, causal: bool,
                fused: Optional[bool] = None,
                mrope_positions: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None, data_group=None,
                par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block in turn -> ``(x, aux)``, the blocks' auxiliary losses
    summed a period at a time and the periods in order, as JAX's
    ``apply_period`` and scan sum them; with ``arch.remat`` each block is
    recomputed in the backward pass, so only its [B, S, D] input stays
    alive (a rank's [B, S / tp, D] rows under sequence parallelism, JAX's
    residual constrained to ("batch", "seq", "embed") between blocks)."""
    if fused is None:
        fused = fused_blocks_enabled()
    period = period_length(arch)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, kind) in enumerate(zip(blocks,
                                      _stack_kinds(arch, len(blocks)))):
        blk = functools.partial(apply_block, arch, positions=positions,
                                causal=causal, fused=fused, mixer=kind,
                                mrope_positions=mrope_positions,
                                enc_out=enc_out, data_group=data_group,
                                par=par)
        if arch.remat and torch.is_grad_enabled():
            # no RNG state saved: no block draws random numbers, and saving
            # it would read the generator inside a captured training step;
            # a recorder's recompute runs under the forward's scopes
            x, aux = torch.utils.checkpoint.checkpoint(
                blk, p, x, use_reentrant=False, preserve_rng_state=False,
                context_fn=optrace.checkpoint_contexts)
        else:
            x, aux = blk(p, x)
        per = aux if i % period == 0 else per + aux
        if i % period == period - 1 or i == len(blocks) - 1:
            total = total + per
    return x, total


def period_length(arch: ArchConfig) -> int:
    """Layers in the smallest repeating group of the stack: a hybrid
    stack's period, a MoE's ``every`` where it skips layers, else 1."""
    if arch.family == "hybrid":
        return arch.hybrid_period
    if arch.moe is not None and arch.moe.every > 1:
        return arch.moe.every
    return 1


def layer_kinds(arch: ArchConfig) -> Tuple[str, ...]:
    """The mixer kind of each layer within one period: "attn" or
    "mamba". Layer ``l`` of the flattened stack has kind
    ``layer_kinds(arch)[l % period_length(arch)]``."""
    return tuple("attn" if arch.is_attention_layer(i) else "mamba"
                 for i in range(period_length(arch)))


def _stack_kinds(arch: ArchConfig, num_layers: Optional[int] = None
                 ) -> List[str]:
    """The mixer kind of each layer of a stack of ``num_layers`` (default
    the arch's decoder stack; whisper's encoder has ``enc_layers``)."""
    kinds = layer_kinds(arch)
    n = arch.num_layers if num_layers is None else num_layers
    return [kinds[i % len(kinds)] for i in range(n)]


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


def _decode_block_ffn(arch: ArchConfig, blk: Params, x: torch.Tensor,
                      moe_cap: Optional[int] = None,
                      group=None) -> torch.Tensor:
    """Pre- or post-norm MLP or MoE tail of a block with its residual add
    (none for a block without ln2: mamba2's have no MLP). ``moe_cap`` (a
    prefill chunk's): the full prompt's capacity, so the drops match the
    static engine's full-prompt dispatch rather than a bucket inflated by
    the chunk's padded shape. ``group``: serving tensor parallelism."""
    if "ln2" not in blk:
        return x
    h = x if arch.post_norm else apply_norm(arch.norm, blk["ln2"], x)
    y = _ffn(arch, blk, h, moe_cap=moe_cap, group=group)
    return apply_norm(arch.norm, blk["ln2"], x + y) if arch.post_norm \
        else x + y


def _fused_residual_norm(arch: ArchConfig, ln: Params, d: torch.Tensor,
                         x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the pending residual delta ``d`` into the stream and norm it in
    one kernel: ``x += d; h = norm(x)`` -> ``(h, x_new)``."""
    return ln_ops.decode_residual_norm(d, x, ln["scale"], ln.get("bias"),
                                       kind=arch.norm)


def _fused_block_delta(arch: ArchConfig, blk: Params, h: torch.Tensor,
                       moe_cap: Optional[int] = None,
                       group=None) -> torch.Tensor:
    """MLP or MoE tail of a fused block: the residual *delta*, whose add is
    deferred to the layer's end."""
    return _ffn(arch, blk, h, moe_cap=moe_cap, group=group)


def _period(arch: ArchConfig, blk: Params, x: torch.Tensor,
            mix: Callable[[torch.Tensor], torch.Tensor],
            fused: bool, moe_cap: Optional[int] = None,
            group=None) -> torch.Tensor:
    """One layer around the mixer ``mix``: unfused, or the fused body (ln1
    norm, mixer, fused add + ln2 norm, MLP delta, boundary add). A mamba2
    block has no ln2 and no MLP: its fused body's pending delta is the
    mixer output itself, folded by the boundary add, so with a period of
    one layer fused and unfused are the same operations and no
    ``decode_residual_norm`` runs (fused decode changes only the head).
    The fused body is pre-norm only, as JAX's. ``group``: serving tensor
    parallelism, for the MLP or MoE tail (the mixer takes it itself)."""
    if fused:
        assert not arch.post_norm, (arch.name, "fused decode is pre-norm only")
    if not fused or "ln2" not in blk:
        x = _decode_block_mix(arch, blk, x, mix)
        return _decode_block_ffn(arch, blk, x, moe_cap, group)
    h = apply_norm(arch.norm, blk["ln1"], x)
    h2, x = _fused_residual_norm(arch, blk["ln2"], mix(h), x)
    return x + _fused_block_delta(arch, blk, h2, moe_cap, group)


def paged_decode_period(arch: ArchConfig, blk: Params, cache: Params,
                        x: torch.Tensor, page_table: torch.Tensor,
                        seq_lens: torch.Tensor, active: torch.Tensor,
                        kind: str = "attn", fused: bool = False,
                        group=None) -> torch.Tensor:
    """One layer of single-token decode, dispatched on its mixer ``kind``.
    ``active`` [S] (``seq_lens > 0``) guards a mamba layer's state rows:
    attention routes an idle slot's write to the null page instead.
    ``group``: serving tensor parallelism (attention on the rank's heads,
    the tail's shards; a mamba mixer is replicated and reduces nothing)."""
    def mix(h):
        if kind == "attn":
            return attn_lib.paged_decode_attention_layer(
                arch, blk["attn"], h, cache, page_table, seq_lens,
                group=group)
        return ssm_lib.paged_decode_mamba_layer(arch, blk["mamba"], h, cache,
                                                active)
    return _period(arch, blk, x, mix, fused, group=group)


def paged_decode_stack(arch: ArchConfig, blocks: List[Params],
                       caches: List[Params], x: torch.Tensor,
                       page_table: torch.Tensor, seq_lens: torch.Tensor,
                       fused: bool = False, group=None) -> torch.Tensor:
    """Single-token decode x [B, 1, D] through every layer. A slot with
    seq_len 0 is empty or mid-prefill: its state is left as it was.
    ``group``: serving tensor parallelism."""
    active = seq_lens > 0
    for blk, cache, kind in zip(blocks, caches, _stack_kinds(arch)):
        x = paged_decode_period(arch, blk, cache, x, page_table, seq_lens,
                                active, kind, fused, group)
    return x


# ---- multi-step decode ------------------------------------------------------
# Per-slot exit-reason bits of the multi-step loop (JAX's values). A dispatch
# that ran the full horizon with no bit set exited on the horizon alone.
EXIT_EOS = 1        # slot emitted its request's eos token
EXIT_BUDGET = 2     # slot emitted its last allowed token (max-new / context)
EXIT_PAGES = 4      # slot's next K/V write would fall past its allocated pages


def paged_decode_loop_step(arch: ArchConfig, blocks: List[Params],
                           caches: List[Params], carry: Params, *,
                           horizon: int, embed, unembed=None, select=None,
                           fused_head=None, probe: bool = False,
                           group=None) -> None:
    """One iteration of the multi-step decode loop, the counterpart of the
    body and condition of ``repro.models.transformer.paged_decode_loop``'s
    ``lax.while_loop``, in place over the tensors of ``carry``:

    - inputs: ``page_table`` [S, P], ``active`` [S] (0 or 1), ``budget``,
      ``page_limit`` and ``eos_ids`` [S], all int32 (the host's per-slot loop
      predicates: decode-eligible mask, remaining token allowance,
      allocated pages x page size, eos id or -1);
    - carry: ``i`` [] (iterations run), ``tokens`` and ``lens`` [S] (the
      input token and tokens cached, per slot), ``buf`` [horizon, S]
      (emitted tokens), ``reasons`` [S] (EOS and budget bits), ``ok`` []
      (the finite probe, 1 or 0; updated only with ``probe``);
    - output: ``exits`` [S], ``reasons`` with ``EXIT_PAGES`` where an
      active slot's next write falls past its pages, as JAX computes it
      after its loop.

    JAX's condition becomes the 0-d flag ``live`` computed here on the
    device: ``i < horizon``, no exit bit set, no active slot at its page
    limit. Where it is false the iteration changes nothing the host reads
    or the next step uses: a dead slot (``active & live`` false) is masked
    as the host masks a mid-prefill slot, its page-table row to the null
    page and its ``seq_len`` to 0, so attention writes only the null page
    and a mamba layer keeps the slot's state row; the carry is updated
    only where ``live``. So the host may run more iterations than the loop
    needs (it runs the number it can predict, and only an EOS ends the
    loop earlier), with no host read between them.

    The live iteration is the single step: embed, ``paged_decode_stack``,
    then ``fused_head(x, positions) -> (tokens, ok rows)`` or
    ``select(unembed(x), positions)``, at stream positions ``lens + 1``,
    so every draw's (seed, position) key, and so every token, is the one
    ``decode_steps=1`` draws. Nothing here reads a value on the host.
    ``group``: serving tensor parallelism (the iteration's collectives are
    the stack's reduces; the tokens need none)."""
    i, tok, lens = carry["i"], carry["tokens"], carry["lens"]
    active = carry["active"] != 0
    reasons, page_limit = carry["reasons"], carry["page_limit"]
    blocked = (active & (lens >= page_limit)).any()
    live = (i < horizon) & (reasons == 0).all() & ~blocked
    live_s = active & live
    zero = torch.zeros((), dtype=lens.dtype, device=lens.device)
    page_table = torch.where(live_s[:, None], carry["page_table"], zero)
    seq_lens = torch.where(live_s, lens, zero)
    x = embed(tok[:, None])
    x = paged_decode_stack(arch, blocks, caches, x, page_table, seq_lens,
                           fused=fused_head is not None, group=group)
    if fused_head is not None:
        new, ok_rows = fused_head(x, seq_lens + 1)
        rows_ok = ok_rows | ~active
    else:
        logits = unembed(x)
        new = select(logits, seq_lens + 1)
        # inactive slots read the null page and may produce junk: probe
        # only the live rows
        rows_ok = (torch.isfinite(logits) | ~active[:, None]).all(dim=-1)
    if probe:
        carry["ok"].mul_((rows_ok.all() | ~live).to(carry["ok"].dtype))
    buf = carry["buf"]
    row = i.clamp(max=horizon - 1).long().view(1)
    buf.index_copy_(0, row, torch.where(live, new, buf.index_select(0, row)[0])
                    [None])
    reasons.bitwise_or_(
        torch.where(live_s & (new == carry["eos_ids"]), EXIT_EOS, zero)
        | torch.where(live_s & (i + 1 >= carry["budget"]), EXIT_BUDGET,
                      zero))
    tok.copy_(torch.where(live_s, new, tok))
    lens.add_(live_s.to(lens.dtype))
    i.add_(live.to(i.dtype))
    carry["exits"].copy_(reasons | torch.where(active & (lens >= page_limit),
                                               EXIT_PAGES, zero))


def paged_prefill_period(arch: ArchConfig, blk: Params, cache: Params,
                         x: torch.Tensor, page_row: torch.Tensor, start: int,
                         total_len: int, slot: int = 0, kind: str = "attn",
                         fused: bool = False, moe_cap: Optional[int] = None,
                         group=None) -> torch.Tensor:
    """One layer of one prompt chunk, dispatched on its mixer ``kind``:
    attention writes K/V into the sequence's pages, mamba advances the
    state in the sequence's ``slot`` row; a MoE tail drops at ``moe_cap``
    (the full prompt's capacity) where it is given. ``group``: serving
    tensor parallelism."""
    def mix(h):
        if kind == "attn":
            return attn_lib.paged_prefill_attention_layer(
                arch, blk["attn"], h, cache, page_row, start, total_len,
                group=group)
        return ssm_lib.paged_prefill_mamba_layer(arch, blk["mamba"], h,
                                                 cache, slot, start,
                                                 total_len)
    return _period(arch, blk, x, mix, fused, moe_cap, group)


def paged_prefill_stack(arch: ArchConfig, blocks: List[Params],
                        caches: List[Params], x: torch.Tensor,
                        page_row: torch.Tensor, start: int,
                        total_len: int, slot: int = 0,
                        fused: bool = False, moe_cap: Optional[int] = None,
                        group=None) -> torch.Tensor:
    """Chunked prefill: one prompt chunk x [1, C, D] of one sequence through
    every layer, its K/V written straight into the sequence's pages, its
    mamba state into its slot's rows, its MoE layers dropping at the full
    context's capacity ``moe_cap`` (host-computed by the engine; the
    chunk's own bucket where None). The chunk's trailing padding routes
    too, but the stable expert sort keeps it behind every real token.
    ``group``: serving tensor parallelism."""
    for blk, cache, kind in zip(blocks, caches, _stack_kinds(arch)):
        x = paged_prefill_period(arch, blk, cache, x, page_row, start,
                                 total_len, slot, kind, fused, moe_cap,
                                 group)
    return x


def init_caches(arch: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype, device) -> List[Params]:
    """The static engine's decode caches, one entry per layer of the
    flattened stack: ``attn`` layers a dense ``{k, v}: [B, max_len, Hkv,
    Dh]`` cache (an encdec decoder layer also ``{cross_k, cross_v}: [B,
    enc_seq_len, Hkv, Dh]``, the encoder's K/V), ``mamba`` layers
    ``{conv: [B, W-1, C], state: [B, H, N, P]}``. All are updated in
    place."""
    def layer_cache(kind):
        if kind == "attn":
            c = attn_lib.init_kv_cache(arch, batch, max_len, dtype, device)
            if arch.family == "encdec":
                shape = (batch, arch.enc_seq_len, arch.num_kv_heads,
                         arch.resolved_head_dim)
                for name in ("cross_k", "cross_v"):
                    c[name] = torch.zeros(shape, dtype=dtype, device=device)
            return c
        return ssm_lib.init_mamba_cache(arch, batch, dtype, device)
    return [layer_cache(k) for k in _stack_kinds(arch)]


def decode_period(arch: ArchConfig, blk: Params, cache: Params,
                  x: torch.Tensor, positions: torch.Tensor,
                  kind: str = "attn",
                  mrope_positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One layer of the static engine over S new tokens x [B, S, D] (S > 1
    prefill, S == 1 decode) at cache rows ``positions`` [B], dispatched on
    its mixer ``kind``; the layer's cache is updated in place. A whisper
    decoder layer attends to the encoder's K/V in its cache after the
    mixer."""
    def mix(h):
        if kind == "attn":
            return attn_lib.extend_attention(arch, blk["attn"], h, cache,
                                             positions, mrope_positions)
        y, new = ssm_lib.extend_mamba(arch, blk["mamba"], h, cache)
        cache["conv"].copy_(new["conv"])
        cache["state"].copy_(new["state"])
        return y
    x = _decode_block_mix(arch, blk, x, mix)
    if "xattn" in blk:
        x = x + _cross(arch, blk, x, (cache["cross_k"], cache["cross_v"]))
    return _decode_block_ffn(arch, blk, x)


def decode_stack(arch: ArchConfig, blocks: List[Params],
                 caches: List[Params], x: torch.Tensor,
                 positions: torch.Tensor,
                 mrope_positions: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Every layer of the static engine in turn (prefill or one decode
    step); returns the activations, the caches are updated in place."""
    for blk, cache, kind in zip(blocks, caches, _stack_kinds(arch)):
        x = decode_period(arch, blk, cache, x, positions, kind,
                          mrope_positions)
    return x


def chunk_final_hidden(x: torch.Tensor, start: int,
                       total_len: int) -> torch.Tensor:
    """[B, C, D] chunk activations -> [B, 1, D] of the chunk's last valid
    token (position ``total_len - 1``): the final chunk's logits surface."""
    i = total_len - 1 - start
    return x[:, i:i + 1]
