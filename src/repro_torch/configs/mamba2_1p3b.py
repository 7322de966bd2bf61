"""mamba2-1.3b [ssm] (arXiv:2405.21060): 48 layers, d_model 2048,
attention-free, vocab 50280 (padded to 50304), SSD state 128, inner dim
4096 = 64 heads of 64 channels, tied embeddings."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2_048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="none",
    use_bias=False,
    tie_embeddings=True,
    ssm=SSMConfig(
        state_dim=128,
        head_dim=64,
        expand=2,
        chunk=256,
        conv_width=4,
        ngroups=1,
    ),
)
