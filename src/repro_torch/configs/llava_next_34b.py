"""llava-next-34b [vlm] — anyres tiling (hf:llava-hf/llava-v1.6).

Assignment: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The anyres vision frontend is a STUB: input_specs() provides precomputed
patch embeddings (n_prefix_embeds tokens) per the assignment.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab=64_000,
    frontend="vision_stub",
    n_prefix_embeds=2880,  # anyres: base 576 + 4 tiles x 576
    rope_theta=5_000_000.0,
)
