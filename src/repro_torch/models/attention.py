"""GQA attention: fused QKV projection, RoPE and M-RoPE, the reference
full-matrix attention, the chunked online-softmax attention and the flash
kernel's dispatch (``attention_core``), the full-sequence layer of the
training path, whisper's cross-attention (``apply_cross_attention`` over
the encoder's K/V from ``project_enc_kv``), the static engine's
dense-cache layer (``extend_attention``) and the paged prefill / decode
layers of the continuous engine. Counterpart of ``repro.models.attention``.
Every layer that encodes positions takes ``mrope_positions`` [3, B, S]
(qwen2-vl's t / h / w ids); without them an M-RoPE arch rotates by the
text-only broadcast of its positions, as JAX's does. The engines pass none.

The JAX layers return new caches and page pools; here K/V rows are written
into them in place with ``index_put_`` (the caches and pools are the
engines' own buffers, so the update costs a few rows instead of a copy).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.optrace import scope
from .layers import (Params, apply_mrope, apply_rope, dense,
                     row_parallel_dense)

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
                    positions: torch.Tensor,
                    mrope_positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if arch.pos_emb == "rope":
        return (apply_rope(q, positions, arch.rope_theta),
                apply_rope(k, positions, arch.rope_theta))
    if arch.pos_emb == "mrope":
        if mrope_positions is None:
            # text-only: t == h == w == position
            mrope_positions = positions[None].expand((3,) + positions.shape)
        return (apply_mrope(q, mrope_positions, arch.rope_theta),
                apply_mrope(k, mrope_positions, arch.rope_theta))
    if arch.pos_emb in ("learned", "sinusoidal", "none"):
        return q, k         # added at the embedding (or not at all)
    raise ValueError(f"unknown pos_emb {arch.pos_emb!r}")


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


def _mask_scores(s: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, *,
                 causal: bool, window: int,
                 kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Causal / sliding-window / per-batch valid-length masking of scores
    [B, Hq, Sq, Sk] at query positions ``rows`` [Sq, 1] and key positions
    ``cols`` [1, Sk] (masked scores are the finite NEG_INF)."""
    if causal:
        s = torch.where((cols <= rows)[None, None], s, NEG_INF)
    if window > 0:
        s = torch.where((cols > rows - window)[None, None], s, NEG_INF)
    if kv_len is not None:                       # per-batch valid length [B]
        valid = cols[None] < kv_len.to(s.device)[:, None, None]  # [B,1,Sk]
        s = torch.where(valid[:, None], s, NEG_INF)
    return s


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None,
                    window: int = 0) -> torch.Tensor:
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
    s = _mask_scores(s, rows, cols, causal=causal, window=window,
                     kv_len=kv_len)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_values(p, v)


def _chunk_mask(sq: int, j0: int, n: int, *, causal: bool, q_offset: int,
                window: int, kv_len, scores: torch.Tensor) -> torch.Tensor:
    """Causal / window / cache-length masking of one [B, Hq, Sq, n] score
    tile, the keys ``j0 .. j0 + n - 1``."""
    rows = torch.arange(sq, device=scores.device)[:, None] + q_offset
    cols = j0 + torch.arange(n, device=scores.device)[None, :]
    return _mask_scores(scores, rows, cols, causal=causal, window=window,
                        kv_len=kv_len)


def _chunked_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[torch.Tensor], causal: bool,
                     chunk: int, q_offset: int, window: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_chunked_fwd_impl`` on K/V already a chunk multiple ->
    (out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] fp32)."""
    b, sq, hq, d = q.shape
    scale = 1.0 / torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                        device=q.device))
    o = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    for j in range(k.shape[1] // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        s = _gqa_scores(q, kj).float() * scale            # [B,Hq,Sq,chunk]
        s = _chunk_mask(sq, j * chunk, chunk, causal=causal,
                        q_offset=q_offset, window=window, kv_len=kv_len,
                        scores=s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = _gqa_values(p.to(q.dtype), vj)                # [B,Sq,Hq,D]
        o = o * alpha[..., None] + pv.transpose(1, 2).float()
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (o / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)


class _ChunkedAttn(torch.autograd.Function):
    """JAX's ``_chunked_attn`` custom VJP (``repro.models.attention``):
    the forward keeps only q, k, v, kv_len, the output and the row
    log-sum-exp; the backward recomputes one [B, Hq, Sq, chunk] score tile
    at a time with the forward's masks, so no chunk's tile outlives its
    step in either direction (autodiff of the forward loop would save
    every chunk's tiles). The backward's products run in fp32 on the
    upcast inputs, as JAX's; dq, dk, dv are rounded once into their
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal: bool, chunk: int,
                q_offset: int, window: int):
        out, lse = _chunked_forward(q, k, v, kv_len, causal, chunk,
                                    q_offset, window)
        ctx.save_for_backward(q, k, v, kv_len, out, lse)
        ctx.args = (causal, chunk, q_offset, window)
        return out

    @staticmethod
    def backward(ctx, do):
        causal, chunk, q_offset, window = ctx.args
        return tiled_attention_bwd(*ctx.saved_tensors, do, causal=causal,
                                   chunk=chunk, q_offset=q_offset,
                                   window=window) + (None,) * 5


def empty_rows(sq: int, kv_len: torch.Tensor, *, causal: bool,
               q_offset: int, window: int) -> torch.Tensor:
    """[B, Sq] bool: the query rows that these masks leave without a valid
    key (``kv_len`` [B] the valid keys of each batch row)."""
    pos = torch.arange(sq, device=kv_len.device) + q_offset
    lens = kv_len.long()[:, None]
    hi = torch.minimum(lens, pos + 1) if causal else lens
    lo = (pos - window + 1).clamp_min(0) if window > 0 \
        else torch.zeros_like(pos)
    return hi <= lo


def tiled_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor], out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool, chunk: int, q_offset: int = 0,
                        window: int = 0,
                        empty: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's ``_chunked_attn_bwd``: -> (dq, dk, dv) in the inputs' dtypes,
    for q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], the forward's output and
    row log-sum-exp ``lse`` [B, Hq, Sq] and the output's gradient ``do``.
    It recomputes one [B, Hq, Sq, chunk] score tile at a time with the
    forward's masks; the last tile is shorter where Sk is not a multiple
    of ``chunk``. The products run in fp32 on the upcast inputs; dq is
    summed over the tiles in fp32 and rounded once, each tile's dk and dv
    rounded once.

    A row with no valid key averages V over all Sk keys in the forward
    (every score the finite NEG_INF), but its lse rounds to NEG_INF in
    fp32, so ``exp(s - lse)`` is 1 for every key, not 1 / Sk. With
    ``empty`` ([B, Sq] bool, ``empty_rows``) such rows take p = 1 / Sk
    and no score gradient (their scores are constants), which is
    autodiff's gradient of the forward; without it (the chunked path, as
    JAX's) they keep JAX's values."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                        device=q.device))
    do_f = do.float()
    do_g = do_f.reshape(b, sq, hkv, g, d)
    delta = (do_f * out.float()).sum(dim=-1).transpose(1, 2)  # [B,Hq,Sq]
    delta = delta.reshape(b, hkv, g, sq)[..., None]
    qf = q.float().reshape(b, sq, hkv, g, d)
    dq = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32,
                     device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if empty is not None:
        empty = empty[:, None, None, :, None]                # [B,1,1,Sq,1]
    for j0 in range(0, sk, chunk):
        n = min(chunk, sk - j0)
        cols = slice(j0, j0 + n)
        kj, vj = k[:, cols], v[:, cols]
        s = _gqa_scores(q, kj).float() * scale           # [B,Hq,Sq,n]
        s = _chunk_mask(sq, j0, n, causal=causal, q_offset=q_offset,
                        window=window, kv_len=kv_len, scores=s)
        pg = torch.exp(s - lse[..., None]).reshape(b, hkv, g, sq, n)
        if empty is not None:
            pg = torch.where(empty, 1.0 / sk, pg)
        dv[:, cols] = torch.einsum("bhgqc,bqhgd->bchd", pg,
                                   do_g).to(v.dtype)
        dp = torch.einsum("bqhgd,bchd->bhgqc", do_g, vj.float())
        ds = pg * (dp - delta) * scale
        if empty is not None:
            ds = torch.where(empty, 0.0, ds)
        dq = dq + torch.einsum("bhgqc,bchd->bqhgd", ds, kj.float())
        dk[:, cols] = torch.einsum("bhgqc,bqhgd->bchd", ds, qf).to(k.dtype)
    return dq.reshape(b, sq, hq, d).to(q.dtype), dk, dv


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int, q_offset: int = 0,
                      kv_len: Optional[torch.Tensor] = None,
                      window: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks with JAX's flash-style
    custom VJP (``_ChunkedAttn``). The peak live score tile is [B, Hq, Sq,
    chunk], never [Sq, Sk], forward and backward. K/V are zero-padded to a
    chunk multiple and the tail masked through ``kv_len``. p is rounded to
    the model dtype before p V, as in JAX."""
    b = q.shape[0]
    sk = k.shape[1]
    if sk % chunk:
        pad = chunk - sk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        tail = torch.full((b,), sk, dtype=torch.int64, device=q.device)
        kv_len = tail if kv_len is None else torch.minimum(
            kv_len.to(q.device).long(), tail)
    return _ChunkedAttn.apply(q, k, v, kv_len, causal, chunk, q_offset,
                              window)


def attention_core(arch: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, causal: bool, q_offset: int = 0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's dispatch: the naive path for ``attn_impl == "naive"``, a KV
    length of at most ``attn_chunk`` or a single query (decode); above it
    the chunked online softmax, or for ``attn_impl == "flash"`` the flash
    kernel's wrapper with ``block_kv = attn_chunk`` (on the card always the
    kernel: JAX's TPU-only ``supported()`` gate has no counterpart)."""
    impl = arch.attn_impl
    kwargs = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                  window=arch.window)
    if impl == "naive" or k.shape[1] <= arch.attn_chunk or q.shape[1] == 1:
        return naive_attention(q, k, v, **kwargs)
    if impl == "flash":
        from ..kernels.flash_attention import ops as flash_ops
        return flash_ops.flash_attention(q, k, v, block_kv=arch.attn_chunk,
                                         **kwargs)
    if impl == "chunked":
        return chunked_attention(q, k, v, chunk=arch.attn_chunk, **kwargs)
    raise ValueError(f"unknown attn_impl {impl!r}")


def apply_attention(arch: ArchConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    mrope_positions: Optional[torch.Tensor] = None,
                    par=None) -> torch.Tensor:
    """Self-attention over the full sequence x [B, S, D] (training, and
    whisper's bidirectional encoder). On a training mesh with a model axis
    (``par``) the rank's heads (``_rank_attention``)."""
    if par is not None and par.model is not None:
        return _rank_attention(arch, p, x, positions, causal,
                               mrope_positions, par)
    b, s, _ = x.shape
    with scope("attn_qkv"):
        q, k, v = qkv_project(arch, p, x)
        q, k = position_encode(arch, q, k, positions, mrope_positions)
    with scope("attn_core"):
        o = attention_core(arch, q, k, v, causal=causal)
    with scope("attn_out"):
        return dense(o.reshape(b, s, arch.q_dim), p["wo"], p.get("bo"))


def _rank_kv_weight(arch: ArchConfig, w: torch.Tensor,
                    b: Optional[torch.Tensor], par
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               torch.Tensor, Optional[torch.Tensor]]:
    """Where the model axis outnumbers the KV heads, a rank's block of the
    fused ``wqkv`` holds ``kv_dim / tp`` columns of a KV head its query
    heads share with other ranks. Every rank's K/V columns (and bias
    entries, as an extra row) are gathered over the model axis and the
    rank keeps the head its queries read (``r Hkv / tp``); the gather's
    reduce-scatter backward sums the gradients of the ranks that read a
    head into the ranks that hold its columns. -> (wk, bk, wv, bv) of
    that head."""
    tp, hd = par.tp, arch.resolved_head_dim
    kvl = arch.kv_dim // tp
    kv = w[:, arch.q_dim // tp:]
    if b is not None:
        kv = torch.cat([kv, b[arch.q_dim // tp:][None].to(kv.dtype)], 0)
    from ..parallel import collectives
    every = collectives.gather_seq(kv[None].contiguous(), par.model,
                                   dim=0)                 # [tp, D(+1), 2kvl]
    head = par.mrank * arch.num_kv_heads // tp
    rows = every.shape[1]

    def cols(part):
        whole = every[:, :, part * kvl:(part + 1) * kvl]
        whole = whole.permute(1, 0, 2).reshape(rows, tp * kvl)
        return whole[:, head * hd:(head + 1) * hd]
    k, v = cols(0), cols(1)
    if b is None:
        return k, None, v, None
    return k[:-1], k[-1], v[:-1], v[-1]


def _rank_attention(arch: ArchConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool,
                    mrope_positions: Optional[torch.Tensor],
                    par) -> torch.Tensor:
    """A model rank's heads of the training self-attention: x enters the
    tensor-parallel region (``par.enter``: the whole sequence), the rank's
    block of the fused ``wqkv`` (its query heads' q columns and their K/V
    heads' k and v columns, ``parallel.sharding.train_block_index``)
    projects its Hq / tp query heads and Hkv / tp KV heads (one KV head,
    gathered, where tp > Hkv: ``_rank_kv_weight``), RoPE / M-RoPE at the
    whole sequence's positions, the attention of those heads, the rank's
    rows of ``wo`` give a partial sum that leaves the region
    (``par.exit``), and the replicated ``bo`` is added once, after."""
    tp, hd = par.tp, arch.resolved_head_dim
    x = par.enter(x)
    b, s, _ = x.shape
    ql, kvl = arch.q_dim // tp, arch.kv_dim // tp
    w, bias = p["wqkv"], p.get("bqkv")
    with scope("attn_qkv"):
        if arch.num_kv_heads % tp == 0:
            qkv = dense(x, w, bias)
            q, k, v = torch.split(qkv, [ql, kvl, kvl], dim=-1)
        else:
            q = dense(x, w[:, :ql], None if bias is None else bias[:ql])
            wk, bk, wv, bv = _rank_kv_weight(arch, w, bias, par)
            k, v = dense(x, wk, bk), dense(x, wv, bv)
        q = q.reshape(b, s, -1, hd)
        k, v = k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd)
        q, k = position_encode(arch, q, k, positions, mrope_positions)
    with scope("attn_core"):
        o = attention_core(arch, q, k, v, causal=causal)
    with scope("attn_out"):
        y = par.exit(dense(o.reshape(b, s, ql), p["wo"]))
        return y + p["bo"].to(y.dtype) if "bo" in p else y


def apply_cross_attention(arch: ArchConfig, p: Params, x: torch.Tensor,
                          enc_kv: Tuple[torch.Tensor, torch.Tensor]
                          ) -> torch.Tensor:
    """Whisper's cross-attention: queries from x [B, S, D] against the
    encoder's K/V [B, Senc, Hkv, Dh], no mask (above ``attn_chunk`` keys the
    chunked path or the flash kernel, as ``attention_core`` picks)."""
    b, s, _ = x.shape
    hd = arch.resolved_head_dim
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, arch.num_heads, hd)
    k, v = enc_kv
    o = attention_core(arch, q, k, v, causal=False)
    return dense(o.reshape(b, s, arch.q_dim), p["wo"], p.get("bo"))


def project_enc_kv(arch: ArchConfig, p: Params, enc_out: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output [B, Senc, D] -> cross K, V [B, Senc, Hkv, Dh]."""
    b, s, _ = enc_out.shape
    hd = arch.resolved_head_dim
    k = dense(enc_out, p["wk"], p.get("bk")).reshape(b, s, arch.num_kv_heads,
                                                     hd)
    v = dense(enc_out, p["wv"], p.get("bv")).reshape(b, s, arch.num_kv_heads,
                                                     hd)
    return k, v


def init_kv_cache(arch: ArchConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> Params:
    """The static engine's dense cache ``{k, v}: [B, max_len, Hkv, Dh]``
    for one attention layer, zeros."""
    shape = (batch, max_len, arch.num_kv_heads, arch.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _update_cache_row(cache: torch.Tensor, new_rows: torch.Tensor,
                      positions: torch.Tensor) -> None:
    """Write ``new_rows`` [B, S, Hkv, D] into ``cache`` [B, Smax, Hkv, D] at
    rows ``positions[b] ..`` of each batch row, in place. A start that would
    run past the cache is clamped to ``Smax - S``, as JAX's
    ``dynamic_update_slice`` clamps it."""
    b, s = new_rows.shape[:2]
    start = positions.to(cache.device).long().clamp(0, cache.shape[1] - s)
    rows = start[:, None] + torch.arange(s, device=cache.device)[None]
    cache.index_put_((torch.arange(b, device=cache.device)[:, None], rows),
                     new_rows.to(cache.dtype))


def extend_attention(arch: ArchConfig, p: Params, x: torch.Tensor,
                     cache: Params, positions: torch.Tensor,
                     mrope_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Attend S new tokens x [B, S, D] against (and into) the dense cache;
    ``positions`` [B] is the first cache row of the new tokens. The new K/V
    rows are written into ``cache`` in place. S > 1 is prefill (positions
    0): attention over the fresh K/V, causal, through ``attention_core``
    (chunked or flash above ``attn_chunk``). S == 1 is decode: one query
    against the cache with ``kv_len = positions + 1``."""
    b, s, _ = x.shape
    q, k, v = qkv_project(arch, p, x)                         # [B,S,H*,D]
    qpos = positions.to(x.device).long()[:, None] \
        + torch.arange(s, device=x.device)[None]
    q, k = position_encode(arch, q, k, qpos, mrope_positions)
    _update_cache_row(cache["k"], k, positions)
    _update_cache_row(cache["v"], v, positions)
    if s > 1:
        o = attention_core(arch, q, k, v, causal=True)
    else:
        o = attention_core(arch, q, cache["k"], cache["v"], causal=False,
                           kv_len=positions.to(x.device) + s)
    return dense(o.reshape(b, s, arch.q_dim), p["wo"], p.get("bo"))


def decode_attention(arch: ArchConfig, p: Params, x: torch.Tensor,
                     cache: Params, positions: torch.Tensor,
                     mrope_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token decode. x [B, 1, D]; positions [B] (the new token's cache
    row)."""
    return extend_attention(arch, p, x, cache, positions, mrope_positions)


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
                                  total_len: int,
                                  mrope_positions: Optional[torch.Tensor]
                                  = None, group=None) -> torch.Tensor:
    """One prompt chunk x [1, C, D] of a single sequence (row i at position
    ``start + i``; rows at or past ``total_len`` are padding). Its K/V rows
    are written into ``cache`` in place (padding rows and rows past the
    allocated pages go to the null page 0); returns the layer output.
    Under tensor parallelism (``group``) the rank's weights project its
    own query and KV heads, ``cache`` holds those heads of every page, and
    the output projection is row-parallel (``row_parallel_dense``), the
    layer's one collective."""
    from ..kernels.decode_attention import ops as pd_ops
    _, c, _ = x.shape
    page_size = cache["k"].shape[1]
    max_pages = page_row.shape[0]
    q, k, v = qkv_project(arch, p, x)                          # [1,C,H*,D]
    pos = start + torch.arange(c, dtype=torch.int64, device=x.device)
    q, k = position_encode(arch, q, k, pos[None], mrope_positions)
    logical = pos // page_size
    valid = (pos < total_len) & (logical < max_pages)
    pids = torch.where(valid, page_row.long()[logical.clamp(0, max_pages - 1)],
                       0)
    offs = pos % page_size
    cache["k"].index_put_((pids, offs), k[0])
    cache["v"].index_put_((pids, offs), v[0])
    # the kernel takes a contiguous q; without RoPE (jamba's pos_emb
    # "none") q is still a column view of the fused QKV projection
    o = pd_ops.paged_prefill_attention(q[0].contiguous(), cache["k"],
                                       cache["v"], page_row, start,
                                       total_len)
    return row_parallel_dense(o.reshape(1, c, -1), p["wo"], p.get("bo"),
                              group)


def paged_decode_attention_layer(arch: ArchConfig, p: Params,
                                 x: torch.Tensor, cache: Params,
                                 page_table: torch.Tensor,
                                 seq_lens: torch.Tensor,
                                 mrope_positions: Optional[torch.Tensor]
                                 = None, group=None) -> torch.Tensor:
    """One-token decode x [B, 1, D] against the paged cache. ``seq_lens``
    [B] = tokens already cached (the new token's position); inactive slots
    carry 0, write to the null page and produce output the engine never
    reads. The new K/V rows are written into ``cache`` in place. Under
    tensor parallelism (``group``) as the prefill layer: the rank's heads,
    their page shard, one reduce."""
    from ..kernels.decode_attention import ops as pd_ops
    b = x.shape[0]
    page_size = cache["k"].shape[1]
    q, k, v = qkv_project(arch, p, x)                          # [B,1,H*,D]
    lens = seq_lens.long()
    q, k = position_encode(arch, q, k, lens[:, None], mrope_positions)
    pids = page_table.long()[torch.arange(b, device=x.device),
                             lens // page_size]
    offs = lens % page_size
    cache["k"].index_put_((pids, offs), k[:, 0])
    cache["v"].index_put_((pids, offs), v[:, 0])
    o = pd_ops.paged_decode_attention(q[:, 0].contiguous(), cache["k"],
                                      cache["v"], page_table, seq_lens + 1)
    return row_parallel_dense(o.reshape(b, 1, -1), p["wo"], p.get("bo"),
                              group)
