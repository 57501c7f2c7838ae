"""minicpm3-4b [dense] — MLA (hf:openbmb/MiniCPM3-4B).

Assignment: 62L d_model=2560 40H d_ff=6400 vocab=73448.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73_448,
    attn_type="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    tie_embeddings=True,
)
