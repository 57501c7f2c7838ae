"""deepseek-v2-236b [moe] — MLA + 2 shared / 160 routed top-6 (arXiv:2405.04434).

Assignment: 60L d_model=5120 128H d_ff=1536 vocab=102400, MLA kv_lora=512.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,            # dense-prefix layer width (HF config)
    vocab=102_400,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1536,
    moe_dense_prefix=1,
)
