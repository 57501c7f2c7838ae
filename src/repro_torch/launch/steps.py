"""Serving steps: the port of the JAX package's ``launch/steps.py``
``make_prefill_step`` and ``make_serve_step``.

Each step runs under ``torch.inference_mode()`` (no autograd graph: at
full size the weights leave no room for one) and returns the greedy next
token (B, 1) int32 and the caches. The serve step writes the token's k/v
into the caches in place. The training step is ``launch.train``'s
``make_step``; the sharding-spec functions wait for
``parallel/sharding.py`` (ROADMAP A10).
"""
from __future__ import annotations

import torch

from ..models import api
from ..models.config import ModelConfig


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The first largest logit of the last position, (B, 1) int32."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def make_prefill_step(cfg: ModelConfig):
    pfn = api.prefill_fn(cfg)

    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, caches = pfn(params, batch)
            return _greedy(logits), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    dfn = api.decode_fn(cfg)

    def serve_step(params, caches, token, pos: int):
        with torch.inference_mode():
            logits, caches = dfn(params, caches, token, pos)
            return _greedy(logits), caches

    return serve_step
