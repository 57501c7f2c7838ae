"""AdamW (the port of the JAX package's ``optim/adamw.py``).

The same arithmetic op for op, in float32, with moments stored in
``moment_dtype``. ``update`` writes the new parameters and moments into
the given tensors, leaf by leaf, so the optimizer needs no second copy of
the model (JAX returns new arrays instead). Sums run in another order than
XLA's, so ``global_norm`` and what follows agree with JAX to rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"
    grad_clip: float = 1.0


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init(params: Any, cfg: AdamWConfig):
    dt = _dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = T.leaves(params)[0].device
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in T.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def update(grads: Any, opt_state: dict, params: Any, cfg: AdamWConfig,
           lr_scale: float = 1.0, grad_norm: torch.Tensor | None = None):
    """Returns (params, opt_state, grad_norm), params and moments updated
    in place. ``grad_norm``, where given, is the norm of the whole
    gradient that ``grads`` are shards of (the sharded step's); otherwise
    ``global_norm(grads)``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    s32 = step.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=s32.device)
    bc1 = 1.0 - torch.pow(f32(b1), s32)
    bc2 = 1.0 - torch.pow(f32(b2), s32)
    lr = cfg.lr * lr_scale
    mdt = _dtype(cfg.moment_dtype)
    for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                          T.leaves(opt_state["m"]), T.leaves(opt_state["v"])):
        g = g.to(torch.float32) * clip
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        del g
        mhat = m32 / bc1
        vhat = v32 / bc2
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
        del m32, v32
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        del mhat, vhat
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, gnorm


def cosine_lr(step: torch.Tensor, warmup: int, total: int, base: float = 1.0,
              floor: float = 0.1) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base * warm * cos
