"""Config registry of the port: ``get_config`` and ``smoke_config``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from . import bert_large, llama3p2_3b
from .base import ArchConfig, RunConfig, ShapeConfig, torch_dtype

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                   for m in (llama3p2_3b, bert_large)}


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}") \
            from None


def smoke_config(name: str) -> ArchConfig:
    """A reduced same-family config with the reductions of
    ``repro.configs.smoke_config`` for a dense arch."""
    full = get_config(name)
    return dataclasses.replace(
        full, name=full.name + "-smoke", num_layers=2, d_model=128, d_ff=256,
        vocab_size=512, head_dim=32, num_heads=4, attn_chunk=64,
        num_kv_heads=min(4, max(1, full.num_kv_heads // 4)) or 1)


__all__ = ["ArchConfig", "REGISTRY", "RunConfig", "ShapeConfig",
           "get_config", "smoke_config", "torch_dtype"]
