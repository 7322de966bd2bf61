"""command-r-35b [dense] (hf:CohereForAI/c4ai-command-r-v01): 40L
d_model=8192 64H (GQA kv=8) head_dim 128, d_ff 22528, vocab 256000 tied,
LayerNorm (with JAX's LayerNorm bias), RoPE theta 8e6, no biases on the
linears. 30.28 B parameters, 60.6 GB in bf16: the one registry arch that
fills one 80 GB card, and its 256,000-entry rows are the sampler's
widest."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    head_dim=128,
    mlp="swiglu",
    norm="layernorm",
    pos_emb="rope",
    rope_theta=8_000_000.0,
    use_bias=False,
    tie_embeddings=True,
)
