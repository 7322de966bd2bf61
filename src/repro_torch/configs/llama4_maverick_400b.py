"""llama4-maverick-400b-a17b [moe] (hf:meta-llama/Llama-4 family): 48L
d_model=5120 40H (GQA kv=8) head_dim 128, d_ff 8192, vocab 202048 with an
untied head, RoPE theta 5e5; MoE on every other layer from layer 1: 128
experts of 8192, top-1, one shared expert. 397.7 B parameters (795 GB in
bf16), about 17 B active a token."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5_120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8_192,
    vocab_size=202_048,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=500_000.0,
    use_bias=False,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        num_shared_experts=1,
        expert_ff=8_192,
        capacity_factor=1.25,
        every=2,
        first=1,
    ),
)
