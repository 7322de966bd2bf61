"""Config registry of the port: ``get_config`` and ``smoke_config``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from . import (bert_large, command_r_35b, deepseek_moe_16b, internlm2_1p8b,
               jamba_v0p1_52b, llama3p2_3b, llama4_maverick_400b,
               mamba2_1p3b, mistral_large_123b, qwen2_vl_2b, whisper_base)
from .base import (ArchConfig, MoEConfig, RunConfig, ShapeConfig, SSMConfig,
                   torch_dtype)

_MODULES = (
    mistral_large_123b, command_r_35b, internlm2_1p8b, llama3p2_3b,
    deepseek_moe_16b, llama4_maverick_400b, whisper_base, mamba2_1p3b,
    jamba_v0p1_52b, qwen2_vl_2b, bert_large,
)

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# the 10 assigned archs, in the JAX registry's order (bert-large, the
# paper's own model, is listed apart)
ASSIGNED: List[str] = [m.CONFIG.name for m in _MODULES[:-1]]


def get_config(name: str) -> ArchConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}") \
            from None


def smoke_config(name: str) -> ArchConfig:
    """A reduced same-family config with the reductions of
    ``repro.configs.smoke_config``: a hybrid keeps one whole period of
    layers, an attention-free arch keeps 0 heads and no MLP, a MoE shrinks
    to 4 experts of 256, top-2 at most, an SSD to state 16, head 16,
    chunk 16, and an encoder to 2 layers over 16 frames."""
    full = get_config(name)
    kw = dict(
        name=full.name + "-smoke",
        num_layers=max(2, full.hybrid_period) if full.family == "hybrid"
        else 2,
        d_model=128,
        d_ff=0 if full.family == "ssm" else 256,
        vocab_size=512,
        head_dim=32,
        attn_chunk=64,
    )
    if full.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = min(4, max(1, full.num_kv_heads // 4)) or 1
    else:
        kw["num_heads"] = 0
        kw["num_kv_heads"] = 0
    if full.moe is not None:
        kw["moe"] = dataclasses.replace(
            full.moe, num_experts=4, top_k=min(2, full.moe.top_k),
            expert_ff=256 if full.moe.expert_ff else 0)
    if full.ssm is not None:
        kw["ssm"] = dataclasses.replace(full.ssm, state_dim=16, head_dim=16,
                                        chunk=16)
    if full.family == "encdec":
        kw["enc_layers"] = 2
        kw["enc_seq_len"] = 16
    return dataclasses.replace(full, **kw)


__all__ = ["ASSIGNED", "ArchConfig", "MoEConfig", "REGISTRY", "RunConfig",
           "SSMConfig", "ShapeConfig", "get_config", "smoke_config",
           "torch_dtype"]
