from .config import ModelConfig
from . import api

__all__ = ["ModelConfig", "api"]
