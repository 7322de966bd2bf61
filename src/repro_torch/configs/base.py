"""Architecture config: the fields of ``repro.configs.base.ArchConfig`` that
the dense serving path reads, as the port's own frozen dataclass."""
from __future__ import annotations

import dataclasses

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> ``torch.dtype``."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}") \
            from None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # only "dense" is served by the port
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    mlp: str = "swiglu"
    norm: str = "rmsnorm"
    pos_emb: str = "rope"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # compute / activation and weight dtype
    logit_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim
