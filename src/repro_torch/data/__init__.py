from .pipeline import DataConfig, SyntheticLM, wordcount_corpus

__all__ = ["DataConfig", "SyntheticLM", "wordcount_corpus"]
