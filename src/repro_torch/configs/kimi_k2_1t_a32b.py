"""kimi-k2-1t-a32b [moe] — Kimi K2 trillion-param MoE (arXiv:2501.kimi2).

Assignment: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384e top-8. The assignment's d_ff=2048 is the per-expert width; the
single dense first layer uses the HF config's 18432.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18432,            # dense-prefix layer width
    vocab=163_840,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    d_ff_expert=2048,
    moe_dense_prefix=1,
    rope_theta=50_000.0,
)
