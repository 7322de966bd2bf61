"""whisper-base [encdec]: 6 encoder + 6 decoder layers, d_model=512 8H
(MHA) d_ff=2048 vocab=51865 (padded to 51968), head_dim=64, GeLU MLP,
layernorm, biases, tied embeddings. The encoder adds sinusoidal rows to
its frames; the decoder adds no position embedding (as the JAX package's
model). The conv audio frontend is a stub: frame embeddings [B, 1500, D]
arrive precomputed."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2_048,
    vocab_size=51_865,
    head_dim=64,
    mlp="gelu",
    norm="layernorm",
    pos_emb="sinusoidal",
    use_bias=True,
    tie_embeddings=True,
    enc_layers=6,
    enc_seq_len=1_500,
    frontend="audio_stub",
)
