"""whisper-large-v3 [audio] — enc-dec, conv frontend stub (arXiv:2212.04356).

Assignment: 32L d_model=1280 20H d_ff=5120 vocab=51866. 32 encoder + 32
decoder layers; the mel/conv frontend is a STUB (input_specs() provides
precomputed frame embeddings).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    is_encoder_decoder=True,
    n_encoder_layers=32,
    norm_type="layernorm",
    mlp_type="gelu",
    frontend="audio_stub",
    tie_embeddings=True,
)
