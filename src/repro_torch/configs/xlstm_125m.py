"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks (arXiv:2405.04517).

Assignment: 12L d_model=768 4H d_ff=0 vocab=50304 (no separate FFN; the
mixers carry their own projections).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    block_pattern=("m", "s"),
    chunk_size=256,
    scan_layers=False,
)
