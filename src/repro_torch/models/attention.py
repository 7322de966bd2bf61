"""GQA attention: fused QKV projection, RoPE, the reference full-matrix
attention, the full-sequence layer of the training path, and the paged
prefill / decode layers of the serving path. Counterpart of
``repro.models.attention``.

The JAX layers return new page pools; here K/V rows are written into the
pools in place with ``index_put_`` (the pools are the engine's own buffers,
so the update costs a few rows instead of a pool copy).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .layers import Params, apply_rope, dense

NEG_INF = -1e30


def qkv_project(arch: ArchConfig, p: Params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]."""
    b, s, _ = x.shape
    hd = arch.resolved_head_dim
    if "wqkv" in p:
        qkv = dense(x, p["wqkv"], p.get("bqkv"))
        q, k, v = torch.split(qkv, [arch.q_dim, arch.kv_dim, arch.kv_dim],
                              dim=-1)
    else:
        q = dense(x, p["wq"], p.get("bq"))
        k = dense(x, p["wk"], p.get("bk"))
        v = dense(x, p["wv"], p.get("bv"))
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd))


def position_encode(arch: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                    positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if arch.pos_emb == "rope":
        return (apply_rope(q, positions, arch.rope_theta),
                apply_rope(k, positions, arch.rope_theta))
    if arch.pos_emb in ("learned", "none"):
        return q, k         # learned positions are added at the embedding
    raise NotImplementedError(
        f"pos_emb {arch.pos_emb!r}: the port supports rope, learned and none")


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,Hq,D], k [B,Sk,Hkv,D] -> scores [B,Hq,Sq,Sk]."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    return s.reshape(b, hq, sq, k.shape[1])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,Hq,Sq,Sk], v [B,Sk,Hkv,D] -> [B,Sq,Hq,D]."""
    b, hq, sq, sk = p.shape
    hkv = v.shape[2]
    pg = p.reshape(b, hkv, hq // hkv, sq, sk)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg, v)
    return o.reshape(b, sq, hq, v.shape[3])


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference full-matrix attention with an fp32 softmax."""
    d = q.shape[-1]
    # made on q's device: a host-made scalar copied over would make the
    # host wait for the card at every call
    scale = torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                  device=q.device))
    s = _gqa_scores(q, k).float() / scale
    sq, sk = s.shape[2], s.shape[3]
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    cols = torch.arange(sk, device=q.device)[None, :]
    if causal:
        s = torch.where((cols <= rows)[None, None], s, NEG_INF)
    if kv_len is not None:                       # per-batch valid length [B]
        valid = cols[None] < kv_len.to(q.device)[:, None, None]   # [B,1,Sk]
        s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_values(p, v)


def attention_core(arch: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """The JAX package takes the naive path while the KV length is at most
    ``attn_chunk`` (bert-large: 1024 against its 512 positions); beyond it
    JAX chunks (or runs the Pallas flash kernel), which is not ported."""
    if k.shape[1] > arch.attn_chunk:
        raise NotImplementedError(
            f"KV length {k.shape[1]} > attn_chunk {arch.attn_chunk}: "
            "chunked/flash attention not ported")
    return naive_attention(q, k, v, causal=causal)


def apply_attention(arch: ArchConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Training self-attention over the full sequence x [B, S, D]."""
    b, s, _ = x.shape
    q, k, v = qkv_project(arch, p, x)
    q, k = position_encode(arch, q, k, positions)
    o = attention_core(arch, q, k, v, causal=causal)
    return dense(o.reshape(b, s, arch.q_dim), p["wo"], p.get("bo"))


def init_paged_kv_cache(arch: ArchConfig, num_pages: int, page_size: int,
                        dtype: torch.dtype, device) -> Params:
    """Page pool ``{k, v}: [P, page, Hkv, Dh]`` for one attention layer.
    Page 0 is the null page: it absorbs writes from inactive slots and
    padded page-table entries and is never owned by a sequence."""
    shape = (num_pages, page_size, arch.num_kv_heads, arch.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_prefill_attention_layer(arch: ArchConfig, p: Params,
                                  x: torch.Tensor, cache: Params,
                                  page_row: torch.Tensor, start: int,
                                  total_len: int) -> torch.Tensor:
    """One prompt chunk x [1, C, D] of a single sequence (row i at position
    ``start + i``; rows at or past ``total_len`` are padding). Its K/V rows
    are written into ``cache`` in place (padding rows and rows past the
    allocated pages go to the null page 0); returns the layer output."""
    from ..kernels.decode_attention import ops as pd_ops
    _, c, _ = x.shape
    page_size = cache["k"].shape[1]
    max_pages = page_row.shape[0]
    q, k, v = qkv_project(arch, p, x)                          # [1,C,H*,D]
    pos = start + torch.arange(c, dtype=torch.int64, device=x.device)
    q, k = position_encode(arch, q, k, pos[None])
    logical = pos // page_size
    valid = (pos < total_len) & (logical < max_pages)
    pids = torch.where(valid, page_row.long()[logical.clamp(0, max_pages - 1)],
                       0)
    offs = pos % page_size
    cache["k"].index_put_((pids, offs), k[0])
    cache["v"].index_put_((pids, offs), v[0])
    o = pd_ops.paged_prefill_attention(q[0], cache["k"], cache["v"], page_row,
                                       start, total_len)
    return dense(o.reshape(1, c, -1), p["wo"], p.get("bo"))


def paged_decode_attention_layer(arch: ArchConfig, p: Params,
                                 x: torch.Tensor, cache: Params,
                                 page_table: torch.Tensor,
                                 seq_lens: torch.Tensor) -> torch.Tensor:
    """One-token decode x [B, 1, D] against the paged cache. ``seq_lens``
    [B] = tokens already cached (the new token's position); inactive slots
    carry 0, write to the null page and produce output the engine never
    reads. The new K/V rows are written into ``cache`` in place."""
    from ..kernels.decode_attention import ops as pd_ops
    b = x.shape[0]
    page_size = cache["k"].shape[1]
    q, k, v = qkv_project(arch, p, x)                          # [B,1,H*,D]
    lens = seq_lens.long()
    q, k = position_encode(arch, q, k, lens[:, None])
    pids = page_table.long()[torch.arange(b, device=x.device),
                             lens // page_size]
    offs = lens % page_size
    cache["k"].index_put_((pids, offs), k[:, 0])
    cache["v"].index_put_((pids, offs), v[:, 0])
    o = pd_ops.paged_decode_attention(q[:, 0], cache["k"], cache["v"],
                                      page_table, seq_lens + 1)
    return dense(o.reshape(b, 1, -1), p["wo"], p.get("bo"))
