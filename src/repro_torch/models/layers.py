"""Shared building blocks: norms, rotary embeddings, MLPs, initializers.

The port of the JAX package's ``models/layers.py``: the same parameter
shapes and the same float32 working precision of norms and rotary
embeddings, so a converted parameter tree gives the JAX model's numbers to
rounding. Initializers draw from an explicit ``torch.Generator``; their
values are the port's own.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    if gen.device.type == "meta":       # ``api.init_fn`` on the meta device
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(std).to(dtype)


def dense_init(gen, shape, dtype, scale: float = 1.0):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return _normal(gen, shape, scale / math.sqrt(fan_in), dtype)


def embed_init(gen, shape, dtype):
    return _normal(gen, shape, 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dim: int | None = None):
    d = dim or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=dtype_of(cfg), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype_of(cfg), device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps):
    """Per-head q/k RMS norm (qwen3 qk_norm). x: (..., hd)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_tables(positions, dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., dim // 2)."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python base: no host-to-device copy (a copy of a host scalar
    # synchronises the stream, once per layer and step)
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., dim); cos/sin: broadcastable (..., dim // 2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    xf1, xf2 = x1.to(torch.float32), x2.to(torch.float32)
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: int):
    d, dt = cfg.d_model, dtype_of(cfg)
    if cfg.mlp_type == "swiglu":
        return {"w_gate": dense_init(gen, (d, d_ff), dt),
                "w_up": dense_init(gen, (d, d_ff), dt),
                "w_down": dense_init(gen, (d_ff, d), dt)}
    return {"w_up": dense_init(gen, (d, d_ff), dt),
            "w_down": dense_init(gen, (d_ff, d), dt)}


def apply_mlp(p, x, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:  # gelu, tanh approximation as jax.nn.gelu(approximate=True)
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


def mlp_einsum(ws, x, cfg: ModelConfig):
    """Batched-expert MLP: ws leaves have a leading expert axis E.

    x: (E, C, d) -> (E, C, d), one batched product per weight over the
    experts (``ecd,edf->ecf``; the JAX package computes it outside any
    Pallas kernel).
    """
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(x, ws["w_gate"])) * torch.bmm(x, ws["w_up"])
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(torch.bmm(x, ws["w_up"])))
    else:  # gelu, tanh approximation
        h = F.gelu(torch.bmm(x, ws["w_up"]), approximate="tanh")
    return torch.bmm(h, ws["w_down"])
