from . import adamw
from .adamw import AdamWConfig, cosine_lr, global_norm

__all__ = ["adamw", "AdamWConfig", "cosine_lr", "global_norm"]
