"""bert-large [dense]: 24L d_model=1024 16H (MHA) d_ff=4096 vocab=30522,
head_dim=64, learned positions (512), GeLU MLP, post-LayerNorm blocks,
biases everywhere, tied MLM head (Devlin et al. 2018; the paper's model)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="bert-large",
    family="dense",
    num_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4_096,
    vocab_size=30_522,
    head_dim=64,
    mlp="gelu",
    norm="layernorm",
    pos_emb="learned",
    use_bias=True,
    tie_embeddings=True,
    post_norm=True,
    bidirectional=True,
    mlm_transform=True,
    max_position=512,
)
