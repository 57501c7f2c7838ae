"""granite-20b [dense] — code model, MQA (arXiv:2405.04324).

Assignment: 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
d_ff = 4*d with a non-gated GELU MLP (gpt_bigcode-style 4x ratio).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab=49_152,
    mlp_type="gelu",
)
