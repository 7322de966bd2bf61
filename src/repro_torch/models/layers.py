"""Primitive layers as plain functions on tensors: dense, norms, activations,
embeddings, sinusoidal positions, rotary embeddings (RoPE and M-RoPE), the
MLP. Counterpart of
``repro.models.layers``; parameter names follow the same contract
(``embedding [V, D]``, ``w1/w3 [D, F]``, ``w2 [F, D]``, ``b1 [F]``,
``b2 [D]``, ``scale/bias [D]``)."""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.optrace import scope
from ..parallel.collectives import wide_product

Params = Dict[str, object]

VOCAB_PAD = 128  # vocab padded to a multiple of this (Megatron-style)


def pad_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def row_parallel_dense(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None,
                       group=None) -> torch.Tensor:
    """``dense`` of a row-parallel projection (attention's ``wo``, the
    MLP's ``w2``). One device: the plain dense. Under tensor parallelism
    (``group``) the rank's ``w`` rows meet only its share of ``x``'s
    features, so the product is a partial sum: it is reduced across the
    ranks in fp32 (``all_reduce``) and the replicated bias is added once,
    after the reduce, as JAX's ``psum`` sites do. JAX writes the sum as
    ``x.astype(f32) @ w.astype(f32)``, which XLA fuses; here
    ``parallel.collectives.wide_product``: no fp32 copy of a 16-bit
    weight on the card."""
    if group is None:
        return dense(x, w, b)
    y = wide_product(x, w)
    dist.all_reduce(y, group=group)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device,
               dtype) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times 1/sqrt(in)."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def init_norm(kind: str, dim: int, dtype: torch.dtype, device) -> Params:
    """``{scale: ones}`` (+ ``bias: zeros`` for layernorm)."""
    p: Params = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p: Params, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm / LayerNorm with fp32 statistics, result in ``x``'s dtype."""
    with scope("norm"):
        return _apply_norm(kind, p, x, eps)


def _apply_norm(kind: str, p: Params, x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GeLU, as BERT's (paper section 3.2.3)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (logaddexp with
    0), with no linear cut-off above a threshold as ``F.softplus`` has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def embed_tokens(p: Params, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return p["embedding"].to(dtype)[tokens]


def vocab_parallel_lookup(table: torch.Tensor, tokens: torch.Tensor,
                          rank: int, dtype: torch.dtype) -> torch.Tensor:
    """The embedding rows of ``tokens`` that a model rank's vocab slice
    ``table`` [Vp / tp, D] holds (rank r holds rows ``[r Vp / tp, (r + 1)
    Vp / tp)``), zeros for the other tokens: the ranks' lookups sum to the
    whole table's, exactly (one row and zeros)."""
    v = table.shape[0]
    local = tokens - rank * v
    inside = (local >= 0) & (local < v)
    rows = table.to(dtype)[local.clamp(0, v - 1)]
    return torch.where(inside[..., None], rows, torch.zeros_like(rows))


def unembed(p: Params, x: torch.Tensor,
            tied_embedding: Optional[torch.Tensor],
            softcap: float = 0.0) -> torch.Tensor:
    """Logits in fp32: the product runs in ``x``'s dtype, then upcasts."""
    if tied_embedding is not None:
        w = tied_embedding.to(x.dtype).T
    else:
        w = p["head"].to(x.dtype)
    logits = (x @ w).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def sinusoidal_positions(seq: int, dim: int, dtype: torch.dtype, device,
                         offset: int = 0) -> torch.Tensor:
    """[seq, dim] rows ``[sin(p / 10000^(2i/dim)), cos(...)]`` for
    positions ``offset ..``, computed in fp32 and cast to ``dtype``."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    base = torch.full((), 10_000.0, dtype=torch.float32, device=device)
    angle = pos / torch.pow(base, 2.0 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """1 / theta^(2i / D) in fp32, evaluated as theta^(-2i / D): the form
    XLA rewrites the JAX expression into under jit, so the frequencies are
    bitwise those of the jitted JAX engines (an ulp apart otherwise, which
    at position 200 moves a rotated key by 2e-5)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return torch.pow(base, -exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, D]; positions broadcastable to
    [..., S]. Computed in fp32, returned in ``x``'s dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)               # [D/2]
    ang = positions.float()[..., None] * freqs                 # [..., S, D/2]
    ang = ang[..., None, :]                                    # [..., S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_streams(half: int, n_t: int, n_h: int,
                   device: torch.device) -> torch.Tensor:
    """[D/2] int64: which position stream (0 t, 1 h, 2 w) each frequency
    dim reads. Made once a device, so a captured decode step reads it."""
    sec = torch.full((half,), 2, dtype=torch.int64)
    sec[:n_t], sec[n_t:n_t + n_h] = 0, 1
    return sec.to(device)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float,
                sections: Tuple[float, float, float] = (0.5, 0.25, 0.25)
                ) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. x: [B, S, H, D]; positions_thw: [3, B,
    S] (temporal, height, width ids; B may be 1 and broadcast). The D/2
    frequency dims split into contiguous (t, h, w) sections, each rotated
    by its own stream, so with t == h == w this is ``apply_rope`` bit for
    bit. Computed in fp32, returned in ``x``'s dtype."""
    d = x.shape[-1]
    half = d // 2
    n_t = int(half * sections[0])
    n_h = int(half * sections[1])
    freqs = rope_frequencies(d, theta, x.device)            # [D/2]
    sec = _mrope_streams(half, n_t, n_h, x.device)
    pos = positions_thw.float().index_select(0, sec)        # [D/2, B, S]
    ang = pos.movedim(0, -1) * freqs                        # [B, S, D/2]
    ang = ang[..., None, :]                                 # [B, S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(kind: str, p: Params, x: torch.Tensor, *,
              fused: bool = False, group=None, par=None) -> torch.Tensor:
    """Feed-forward block. ``fused`` routes a gelu MLP's bias + activation
    through ``kernels.bias_gelu`` (the dense without its bias, then one
    kernel); swiglu has no such epilogue and ignores it. Under tensor
    parallelism (``group``) the weights are the rank's Megatron shards,
    w1 / w3 column-parallel and w2 row-parallel (``row_parallel_dense``).
    On a training mesh with a model axis (``par``, a
    ``parallel.collectives.Parallel``) the same shards in training: x
    enters the tensor-parallel region (``par.enter``: gathered by sequence,
    or copied with its gradient summed), the rank's partial product leaves
    it (``par.exit``), and the replicated ``b2`` is added once, after."""
    with scope("mlp"):
        if par is not None and par.model is not None:
            h = _hidden(kind, p, par.enter(x), fused)
            y = par.exit(dense(h, p["w2"]))
            return y + p["b2"].to(y.dtype) if "b2" in p else y
        return _apply_mlp(kind, p, x, fused=fused, group=group)


def _hidden(kind: str, p: Params, x: torch.Tensor,
            fused: bool) -> torch.Tensor:
    """The MLP's activations before w2."""
    if kind == "swiglu":
        return silu(dense(x, p["w1"], p.get("b1"))) * dense(x, p["w3"],
                                                            p.get("b3"))
    if kind == "gelu":
        if fused:
            from ..kernels.bias_gelu import ops as bg_ops
            return bg_ops.bias_gelu(dense(x, p["w1"]), p.get("b1"))
        return gelu(dense(x, p["w1"], p.get("b1")))
    raise ValueError(kind)


def _apply_mlp(kind: str, p: Params, x: torch.Tensor, *,
               fused: bool = False, group=None) -> torch.Tensor:
    return row_parallel_dense(_hidden(kind, p, x, fused), p["w2"],
                              p.get("b2"), group)
