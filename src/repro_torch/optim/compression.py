"""Gradient compression with error feedback: the port of the JAX package's
``optim/compression.py``.

Workers send sparsified (top-k by magnitude, a ratio of each leaf) or int8
(per-leaf absmax) gradients; the unsent residual is added to the next
step's gradient. The sent gradient stays dense with zeros, so any reduction
tree sums it; ``payload_bytes`` reports the sparse message size the paper's
parameter-server model counts.

The arithmetic is the JAX package's, op for op, so the results are equal
bit for bit: float32 working values, ``round`` half to even, the residual
taken from the float32 sent value. Top-k takes its threshold, the k-th
largest ``|g|`` of the whole leaf, from the top-k kernel's select stage on
a CUDA tensor (its plain version on a CPU tensor); a stacked ``(L, ...)``
leaf has one threshold across its layers, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tree as T
from ..kernels.topk_compress.ops import topk_threshold


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"            # none | topk | int8
    ratio: float = 0.01           # topk: fraction of entries kept per leaf

    @staticmethod
    def parse(spec: str | None) -> "CompressionConfig":
        """"topk:0.01" / "int8" / None."""
        if not spec or spec == "none":
            return CompressionConfig()
        if spec.startswith("topk"):
            ratio = float(spec.split(":")[1]) if ":" in spec else 0.01
            return CompressionConfig("topk", ratio)
        if spec == "int8":
            return CompressionConfig("int8")
        raise ValueError(f"unknown compression spec {spec!r}")


def init_error_feedback(params: Any):
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def topk_count(n: int, ratio: float) -> int:
    """Entries a leaf of ``n`` keeps under top-k."""
    return max(1, int(round(ratio * n)))


def _topk_leaf(g32: torch.Tensor, ratio: float):
    flat = g32.reshape(-1)
    thresh = topk_threshold(flat[None], topk_count(flat.numel(), ratio))[0]
    mask = flat.abs() >= thresh
    sent = torch.where(mask, flat, 0.0).reshape(g32.shape)
    del mask
    return sent, g32 - sent


def _int8_leaf(g32: torch.Tensor):
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    sent = q.to(torch.float32) * scale
    return sent, g32 - sent


def compress_leaf(g: torch.Tensor, e: torch.Tensor, cfg: CompressionConfig):
    """One leaf: (gradient, error feedback) -> (sent in g's dtype, float32
    residual)."""
    g32 = g.to(torch.float32) + e
    if cfg.kind == "topk":
        sent, resid = _topk_leaf(g32, cfg.ratio)
    elif cfg.kind == "int8":
        sent, resid = _int8_leaf(g32)
    else:
        raise ValueError(f"no codec {cfg.kind!r}")
    return sent.to(g.dtype), resid


def compress_tree(grads: Any, ef: Any, cfg: CompressionConfig):
    """(grads, error_feedback) -> (sent_grads, new_error_feedback), both
    with ``grads``' structure (lists kept lists, as ``jax.tree.map`` keeps
    them).

    sent_grads is dense (zeros where dropped) in the original dtype.
    """
    if cfg.kind == "none":
        return grads, ef
    flat_ef = dict(T.leaves_with_paths(ef))
    sent, new_ef = {}, {}
    for path, g in T.leaves_with_paths(grads):
        sent[path], new_ef[path] = compress_leaf(g, flat_ef[path], cfg)
    return T.unflatten(sent, like=grads), T.unflatten(new_ef, like=grads)


def payload_bytes(params: Any, cfg: CompressionConfig) -> int:
    """Per-worker message size under the codec (the PS byte model)."""
    sizes = [p.numel() for p in T.leaves(params)]
    if cfg.kind == "none":
        return 4 * sum(sizes)
    if cfg.kind == "int8":
        return sum(sizes) + 4 * len(sizes)          # int8 + scale/leaf
    return 8 * sum(topk_count(n, cfg.ratio) for n in sizes)  # index + value
