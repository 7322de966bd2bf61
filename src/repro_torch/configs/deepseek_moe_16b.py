"""deepseek-moe-16b [moe] (arXiv:2401.06066): 28L d_model=2048 16H (MHA,
kv=16) head_dim 128, vocab 102400, untied head; fine-grained MoE in every
layer: 64 routed experts of d_ff 1408, top-6, plus 2 shared experts. The
total parameters (16.9 B) far exceed the active ones (2.8 B): the paper's
Takeaway 8, the optimizer's traffic follows the total."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1_408,
    vocab_size=102_400,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    use_bias=False,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        expert_ff=1_408,
        capacity_factor=1.25,
        every=1,
        first=0,
    ),
)
