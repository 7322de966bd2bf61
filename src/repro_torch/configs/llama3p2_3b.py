"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256, head_dim=128, RoPE theta 5e5, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3_072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8_192,
    vocab_size=128_256,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=500_000.0,
    tie_embeddings=True,
)
