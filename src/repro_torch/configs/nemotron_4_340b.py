"""nemotron-4-340b [dense] — GQA + squared-ReLU MLP (arXiv:2402.16819).

Assignment: 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab=256_000,
    mlp_type="relu2",
)
