"""Mamba-style selective SSM (hymba's SSM heads): the port of the Mamba part
of the JAX package's ``models/ssm.py``, for prefill and decode.

The parameter tree and the arithmetic are the JAX model's: the input
projection in the model's dtype, then everything of the scan in float32
(one delta per (b, t), from the last column of the (2N + 1)-wide
projection and ``dt_bias[0]``, as the JAX model computes it), the skip
term, the ``silu(z)`` gate, and the output projection in the model's
dtype. The scan itself runs through ``kernels.ssm_scan.ops`` (the CUDA
kernel on the card, its plain version on CPU tensors) in both
``mamba_forward`` and ``mamba_decode``; ``mamba_forward_sequential`` with
``_mamba_step`` is the plain per-timestep oracle. The state is float32.

xLSTM's mLSTM and sLSTM come with a later slice (ROADMAP A10: ssm).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan.ops import ssm_chunk_scan
from .config import ModelConfig
from .layers import dense_init, dtype_of


def _d_inner(cfg: ModelConfig) -> int:
    return int(cfg.d_inner_mult * cfg.d_model)


def init_mamba(gen, cfg: ModelConfig, d_out: int | None = None):
    """The JAX tree's leaves; the projections drawn from ``gen``, a_log,
    d_skip and dt_bias at the JAX model's initial values."""
    d, di, N = cfg.d_model, _d_inner(cfg), cfg.ssm_state
    dt, dev = dtype_of(cfg), gen.device
    return {
        "w_in": dense_init(gen, (d, 2 * di), dt),            # u, z
        "w_bcdt": dense_init(gen, (di, 2 * N + 1), dt),      # B, C, dt
        "a_log": torch.zeros((di, N), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((di,), -4.0, dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (di, d_out or d), dt),
    }


def mamba_state(cfg: ModelConfig, batch: int, device="cuda"):
    return {"s": torch.zeros((batch, _d_inner(cfg), cfg.ssm_state),
                             dtype=torch.float32, device=device)}


def _delta(p, dt_raw):
    """softplus(dt_raw + dt_bias[0]): one delta per row, as in JAX."""
    return F.softplus(dt_raw + p["dt_bias"][:1])


def _mamba_step(p, s, u_t, z_t, N: int):
    """One timestep of the plain oracle. u_t, z_t: (B, di); s: (B, di, N).
    Returns (s, y (B, di) float32)."""
    uf = u_t.to(torch.float32)
    bcdt = (u_t @ p["w_bcdt"]).to(torch.float32)              # (B, 2N+1)
    bv, cv = bcdt[:, :N], bcdt[:, N:2 * N]
    delta = _delta(p, bcdt[:, -1:])                           # (B, 1)
    a = -torch.exp(p["a_log"])                                # (di, N)
    decay = torch.exp(delta[..., None] * a[None])             # (B, di, N)
    s = s * decay + (delta * uf)[..., None] * bv[:, None, :]
    y = torch.einsum("bdn,bn->bd", s, cv) + p["d_skip"] * uf
    return s, y * F.silu(z_t.to(torch.float32))


def mamba_forward_sequential(p, x, cfg: ModelConfig, state=None):
    """The plain per-timestep form (the JAX package's oracle for the
    chunked scan). x (B, T, d) -> (y (B, T, d_out), {"s"})."""
    b, t, _ = x.shape
    u, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    s = (state or mamba_state(cfg, b, x.device))["s"]
    ys = []
    for i in range(t):
        s, y = _mamba_step(p, s, u[:, i], z[:, i], cfg.ssm_state)
        ys.append(y)
    y = torch.stack(ys, 1).to(x.dtype) @ p["w_out"]
    return y, {"s": s}


def _mamba(p, x, cfg: ModelConfig, s0, s_out=None):
    """Projections, the scan kernel over all of x's T steps, epilogue."""
    N = cfg.ssm_state
    u, z = torch.chunk(x @ p["w_in"], 2, dim=-1)              # (B, T, di)
    bcdt = (u @ p["w_bcdt"]).to(torch.float32)                # (B, T, 2N+1)
    delta = _delta(p, bcdt[..., -1:])                         # (B, T, 1)
    a = -torch.exp(p["a_log"])
    uf = u.to(torch.float32)
    y, s = ssm_chunk_scan(uf, delta, bcdt[..., :N], bcdt[..., N:2 * N], a,
                          s0, s_out)
    y += p["d_skip"] * uf
    y *= F.silu(z.to(torch.float32))
    return y.to(x.dtype) @ p["w_out"], s


def mamba_forward(p, x, cfg: ModelConfig, state=None):
    """x (B, T, d) -> (y (B, T, d_out), {"s": final state}); the scan runs
    in one kernel launch for any T (JAX's chunked form needs T a multiple
    of ``chunk_size`` and takes the sequential form otherwise)."""
    s0 = (state or mamba_state(cfg, x.shape[0], x.device))["s"]
    y, s = _mamba(p, x, cfg, s0)
    return y, {"s": s}


def mamba_decode(p, x, state, cfg: ModelConfig):
    """One token, x (B, 1, d): the scan kernel with T = 1, the new state
    written into ``state["s"]`` in place (JAX returns a new state).
    Returns (y (B, 1, d_out), state)."""
    y, _ = _mamba(p, x, cfg, state["s"], s_out=state["s"])
    return y, state
