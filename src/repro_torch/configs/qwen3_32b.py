"""qwen3-32b [dense] — qk-norm, GQA (hf:Qwen/Qwen3-8B family).

Assignment: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
head_dim=128 (n_heads*head_dim != d_model, as in Qwen3).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
