"""Assigned-architecture registry: ``get(name)`` / ``ARCHS`` (copies of the
JAX package's config files as data, built on the port's ``ModelConfig``)."""
from . import (
    deepseek_v2_236b,
    granite_20b,
    hymba_1_5b,
    kimi_k2_1t_a32b,
    llava_next_34b,
    minicpm3_4b,
    nemotron_4_340b,
    qwen3_32b,
    whisper_large_v3,
    xlstm_125m,
)

_MODULES = [
    kimi_k2_1t_a32b, deepseek_v2_236b, granite_20b, nemotron_4_340b,
    qwen3_32b, minicpm3_4b, llava_next_34b, xlstm_125m, hymba_1_5b,
    whisper_large_v3,
]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
