"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, head_dim=128, M-RoPE theta 1e6 (temporal / height / width
position streams), biases on every projection (the JAX package's
``use_bias`` is global), tied embeddings. The vision frontend is a stub:
patch embeddings would arrive precomputed with [3, B, S] M-RoPE ids."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1_536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8_960,
    vocab_size=151_936,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="mrope",
    rope_theta=1_000_000.0,
    use_bias=True,
    tie_embeddings=True,
    frontend="vision_stub",
)
