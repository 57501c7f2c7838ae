"""Model API and the assigned input shapes: the port of the JAX package's
``models/api.py``, plus the weight and cache converters.

  init_fn(cfg, device)(seed_or_generator) -> params (nested dicts of
      leaf tensors that require grad, keyed as the JAX pytree)
  loss_fn(cfg)(params, batch) -> (loss, metrics)
  prefill_fn(cfg)(params, batch) -> (last_logits, caches)
  decode_fn(cfg)(params, caches, token, pos) -> (logits, caches), the
      caches written in place
  init_caches(cfg, batch, seq, device) -> zero caches (an MoE model's
      dense prefix blocks one each in ``prefix``, then the stack; or one
      per block for the hybrid and xLSTM families)
  input_specs(cfg, shape, mode, device) -> batch of zeros
  params_from_jax(tree_of_numpy) / params_to_numpy(params): 1:1 by key,
      lists kept lists (an MoE model's ``prefix`` blocks, the ``blocks``
      list) and an MoE layer's ``moe/{router, experts, shared}`` leaves as
      they are; caches_from_jax / caches_to_numpy likewise for caches
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tree as T
from . import transformer
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k dense KV excluded "
                       "(DESIGN.md)")
    return True, ""


def init_fn(cfg: ModelConfig, device="cuda"):
    """``init(seed)`` -> params on ``device`` (a seed or a Generator on it)."""
    transformer.check_supported(cfg)

    def init(seed):
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            params = transformer.init_params(cfg, gen)
        return T.tree_map(lambda p: p.requires_grad_(), params)

    return init


def loss_fn(cfg: ModelConfig):
    transformer.check_supported(cfg)
    return lambda params, batch: transformer.loss_fn(params, batch, cfg)


def prefill_fn(cfg: ModelConfig):
    transformer.check_supported(cfg)
    return lambda params, batch: transformer.prefill(params, batch, cfg)


def decode_fn(cfg: ModelConfig):
    transformer.check_supported(cfg)
    return lambda params, caches, token, pos: transformer.decode_step(
        params, caches, token, pos, cfg)


def init_caches(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    return transformer.init_caches(cfg, batch, seq, device)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mode: str | None = None,
                device="cuda"):
    """Batch of zeros for (cfg, shape): tokens (B, S) and, to train, labels,
    int64 as the port's data pipeline makes them (JAX: int32)."""
    mode = mode or shape.kind
    transformer.check_supported(cfg)
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int64, device=device)}
    if mode == "train":
        batch["labels"] = torch.zeros((B, S), dtype=torch.int64,
                                      device=device)
    return batch


# ---------------------------------------------------------------------------
# Weight conversion: the same keys, shapes and layouts, no transposes
# ---------------------------------------------------------------------------

def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """A JAX parameter pytree (numpy or JAX arrays) -> the port's params,
    built by walking the JAX tree, so its lists (hymba's ``blocks``, an MoE
    model's ``prefix`` blocks) stay lists in JAX's leaf order. Empty
    containers (a dense model's ``prefix: []``) carry no leaves and are
    dropped."""
    return T.tree_map(lambda a: _to_tensor(a, device).requires_grad_(),
                      _drop_empty(tree))


def _drop_empty(tree):
    if isinstance(tree, dict):
        out = {k: _drop_empty(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if not (isinstance(v, (dict, list, tuple)) and not v)}
    if isinstance(tree, (list, tuple)):
        return [_drop_empty(v) for v in tree]
    return tree


def caches_from_jax(tree, device="cuda"):
    """A JAX cache tree (numpy or JAX arrays) -> the port's caches, the same
    keys (``prefix``, empty or one cache a dense prefix block, included)."""
    return T.tree_map(lambda a: _to_tensor(a, device), tree)


def caches_to_numpy(caches) -> dict:
    """The port's caches -> the same tree of numpy arrays."""
    return T.tree_map(tensor_to_numpy, caches)


def params_to_numpy(params) -> dict:
    """The port's params -> a nested dict of numpy arrays (bfloat16 as
    ``ml_dtypes.bfloat16`` where numpy has it, else the uint16 bits)."""
    return T.tree_map(tensor_to_numpy, params)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()
