"""The dense model facade of the port: architecture + weights, the weight
init, the token embedding and the LM head. Counterpart of
``repro.models.model.Model`` (``init``, ``_embed``, ``_logits``).

Weights are a plain nested dict of tensors with the JAX package's names,
except that the stacked ``blocks`` become a list with one dict per layer:

    embed.embedding [Vp, D]   final_norm.scale [D]   out.head [D, Vp] (untied)
    blocks[l]: ln1.scale, attn.wqkv [D, q+2kv], attn.wo [q, D], ln2.scale,
               mlp.w1 / mlp.w3 [D, F], mlp.w2 [F, D]
"""
from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..configs.base import ArchConfig, torch_dtype
from .layers import Params, apply_norm, embed_tokens, pad_vocab, unembed


def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device,
                dtype) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times 1/sqrt(in)."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def init_params(arch: ArchConfig, gen: torch.Generator, device,
                dtype: torch.dtype) -> Params:
    """Random weights with the JAX package's distributions (not its bits:
    a parity test converts the JAX weights instead, see ``convert``)."""
    if arch.family != "dense" or arch.mlp != "swiglu":
        raise NotImplementedError(
            f"{arch.name}: the port initializes dense swiglu models only")
    d, hd = arch.d_model, arch.resolved_head_dim
    emb = torch.empty((pad_vocab(arch.vocab_size), d), dtype=torch.float32,
                      device=device)
    emb.normal_(0.0, 1.0, generator=gen)
    p: Params = {"embed": {"embedding": (emb * 0.02).to(dtype)}}
    del emb
    ones = torch.ones((d,), dtype=dtype, device=device)
    blocks = []
    for _ in range(arch.num_layers):
        blocks.append({
            "ln1": {"scale": ones.clone()},
            "attn": {"wqkv": _dense_init(gen, d, arch.q_dim + 2 * arch.kv_dim,
                                         device, dtype),
                     "wo": _dense_init(gen, arch.num_heads * hd, d, device,
                                       dtype)},
            "ln2": {"scale": ones.clone()},
            "mlp": {"w1": _dense_init(gen, d, arch.d_ff, device, dtype),
                    "w2": _dense_init(gen, arch.d_ff, d, device, dtype),
                    "w3": _dense_init(gen, d, arch.d_ff, device, dtype)},
        })
    p["blocks"] = blocks
    p["final_norm"] = {"scale": ones.clone()}
    if not arch.tie_embeddings:
        p["out"] = {"head": _dense_init(gen, d, pad_vocab(arch.vocab_size),
                                        device, dtype)}
    return p


class Model:
    """Architecture + weights on one device."""

    def __init__(self, arch: ArchConfig, params: Params):
        self.arch = arch
        self.params = params
        self.dtype = torch_dtype(arch.dtype)
        self.device = params["embed"]["embedding"].device

    @classmethod
    def init(cls, arch: ArchConfig, generator: torch.Generator,
             device="cuda") -> "Model":
        """Seeded random weights built directly on ``device`` in the
        config's dtype; ``generator`` must live on that device."""
        return cls(arch, init_params(arch, generator, resolve_device(device),
                                     torch_dtype(arch.dtype)))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> [B, S, D] in the compute dtype (rope models add
        no position embedding here)."""
        return embed_tokens(self.params["embed"], tokens.long(), self.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head: [B, S, D] -> fp32 logits [B, S, Vp]."""
        arch = self.arch
        x = apply_norm(arch.norm, self.params["final_norm"], x)
        tied = self.params["embed"]["embedding"] if arch.tie_embeddings \
            else None
        return unembed(self.params.get("out", {}), x, tied, arch.logit_softcap)
