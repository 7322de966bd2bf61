"""jamba-v0.1-52b [hybrid] (arXiv:2403.19887): 32L d_model=4096 32H (GQA
kv=8) head_dim 128, d_ff 14336, vocab 65536, no positional encoding.
Mamba:attention 7:1 (one attention layer a period of 8, at index 4); a MoE
of 16 experts, top-2, on every other layer from layer 1; the mamba layers'
SSD has state 16 (mamba-1 style), heads of 64, inner dim 8192."""
from .base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="none",
    use_bias=False,
    hybrid_period=8,
    hybrid_attn_index=4,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        num_shared_experts=0,
        expert_ff=14_336,
        capacity_factor=1.25,
        every=2,
        first=1,
    ),
    ssm=SSMConfig(
        state_dim=16,
        head_dim=64,
        expand=2,
        chunk=256,
        conv_width=4,
        ngroups=1,
    ),
)
