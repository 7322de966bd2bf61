"""internlm2-1.8b [dense] (arXiv:2403.17297): 24L d_model=2048 16H (GQA
kv=8) head_dim 128, d_ff 8192, vocab 92544, RoPE theta 1e6, untied head.
The smallest dense arch: the optimizer's share of a training step is
largest here (the paper's Takeaway 11)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8_192,
    vocab_size=92_544,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=1_000_000.0,
    use_bias=False,
)
