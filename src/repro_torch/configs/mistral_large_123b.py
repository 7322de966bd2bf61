"""mistral-large-123b [dense] (hf:mistralai/Mistral-Large-Instruct-2407):
88L d_model=12288 96H (GQA kv=8) head_dim 128, d_ff 28672, vocab 32768
with an untied head, RMSNorm, RoPE theta 1e6. 122.6 B parameters (245 GB
in bf16): more than one card holds."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=32_768,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_theta=1_000_000.0,
    use_bias=False,
)
