"""hymba-1.5b [hybrid] — parallel attention + mamba heads (arXiv:2411.13676).

Assignment: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Sliding-window attention except 3 global layers (first /
middle / last), making the arch sub-quadratic for long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    ssm_state=16,
    d_inner_mult=2.0,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    tie_embeddings=True,
    scan_layers=False,
)
