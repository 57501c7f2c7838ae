"""Grouped-query attention: the port of the GQA part of the JAX package's
``models/attention.py``, for training, prefill and decode.

Training is spelled in torch ops as the JAX model spells it in jnp:
``sdpa`` (the kernel's plain version, ``kernels.flash_attention.ref``)
builds the masked (T, S) scores and ``sdpa_blocked`` is the
online-softmax dataflow over (query block, key block) tiles that long
sequences take; autograd runs through them. Prefill and decode run the
flash-attention kernel (``kernels.flash_attention.ops``; its plain version
on CPU tensors), windowed layers with the kernel's sliding window. Shapes:
x (B, T, d); q (B, T, H, hd); k, v and the cache (B, S, Hkv, hd). MLA
comes with a later slice.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.flash_attention.ops import flash_attention_gqa
from ..kernels.flash_attention.ref import sdpa  # noqa: F401  (re-exported)
from .config import ModelConfig
from .layers import (apply_rope, dense_init, dtype_of, rms_head_norm,
                     rope_tables)

NEG_INF = -1e30

# Blocked attention activates for sequences at least this long (and the
# block size), as in the JAX package.
SDPA_BLOCK = 2048


def causal_mask(T: int, S: int, window: int = 0, offset: int = 0,
                device=None):
    """(T, S) boolean mask; q position i attends to keys <= i (+window)."""
    qpos = torch.arange(T, device=device)[:, None] + offset
    kpos = torch.arange(S, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def sdpa_blocked(q, k, v, scale, causal=True, window=0, block=SDPA_BLOCK):
    """Online-softmax blocked attention; the same semantics as ``sdpa``.

    Never builds the (T, S) scores: a double loop over (query block, key
    block) tiles, with causal / sliding-window tiles skipped.
    """
    B, T, H, Dq = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    assert T % block == 0 and S % block == 0
    nq, nk = T // block, S // block
    dev = q.device
    outs = []
    for i in range(nq):
        qi = q[:, i * block:(i + 1) * block].reshape(B, block, Hkv, G, Dq)
        q_lo = i * block
        # causal skipping assumes aligned q/k positions (T == S)
        j_hi = i + 1 if (causal and T == S) else nk
        j_lo = 0
        if window and causal and T == S:
            j_lo = max(0, (q_lo - window) // block)
        m = torch.full((B, Hkv, G, block), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, G, block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, block, Dv), dtype=torch.float32,
                          device=dev)
        for j in range(j_lo, j_hi):
            kj = k[:, j * block:(j + 1) * block]
            vj = v[:, j * block:(j + 1) * block]
            s = torch.einsum("bthgd,bshd->bhgts", qi, kj).to(
                torch.float32) * scale
            if causal and T == S:
                if window:                          # every tile in the band
                    msk = causal_mask(block, block, window,
                                      offset=(i - j) * block, device=dev)
                    s = torch.where(msk, s, NEG_INF)
                elif i == j:                        # diagonal tile
                    s = torch.where(causal_mask(block, block, device=dev), s,
                                    NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgts,bshd->bhgtd", pexp.to(vj.dtype), vj)
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, block, H, Dv))
    return torch.cat(outs, dim=1)


def _pick_block(T: int, S: int, window: int = 0) -> int | None:
    """Tile size for blocked attention, or None to use plain sdpa."""
    block = min(SDPA_BLOCK, window) if window else SDPA_BLOCK
    if T >= block >= 256 and T % block == 0 and S % block == 0:
        return block
    return None


def init_gqa(gen, cfg: ModelConfig):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    p = {"w_q": dense_init(gen, (d, H * hd), dt),
         "w_k": dense_init(gen, (d, Hkv * hd), dt),
         "w_v": dense_init(gen, (d, Hkv * hd), dt),
         "w_o": dense_init(gen, (H * hd, d), dt)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions):
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["w_q"]).reshape(B, T, H, hd)
    k = (x @ p["w_k"]).reshape(B, T, Hkv, hd)
    v = (x @ p["w_v"]).reshape(B, T, Hkv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)   # (T, hd/2)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _scale(cfg: ModelConfig) -> float:
    """1 / sqrt(hd) as the JAX model rounds it (float32), as a Python float
    computed on the host: a decode step never waits for the card."""
    return float(np.float32(1) / np.sqrt(np.float32(cfg.hd)))


def gqa_forward(p, x, cfg: ModelConfig, causal: bool = True, window: int = 0,
                mode: str = "train"):
    """Full-sequence attention. Returns (out, {"k", "v"}).

    ``mode="train"`` runs ``sdpa``/``sdpa_blocked`` (autograd needs them);
    ``mode="prefill"`` runs the flash-attention kernel, with its sliding
    window where the layer has one. As in JAX, the window applies to
    causal attention only."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    if mode == "prefill":
        out = flash_attention_gqa(q, k, v, _scale(cfg), causal=causal,
                                  window=window if causal else 0)
        return out.reshape(B, T, -1) @ p["w_o"], {"k": k, "v": v}
    if mode != "train":
        raise ValueError(f"gqa_forward: mode {mode!r} is train or prefill")
    scale = 1.0 / torch.sqrt(torch.tensor(float(cfg.hd), dtype=torch.float32,
                                          device=x.device))
    block = _pick_block(T, T, window)
    if block:
        out = sdpa_blocked(q, k, v, scale, causal=causal, window=window,
                           block=block)
    else:
        if causal:
            mask = causal_mask(T, T, window, device=x.device)[None]
        else:
            mask = torch.ones((1, T, T), dtype=torch.bool, device=x.device)
        out = sdpa(q, k, v, mask, scale)
    return out.reshape(B, T, -1) @ p["w_o"], {"k": k, "v": v}


def gqa_decode(p, x, cache, pos: int, cfg: ModelConfig, window: int = 0):
    """Single-token decode. x: (B, 1, d); cache k/v: (B, S, Hkv, hd).

    Unlike the JAX function, which returns new arrays, the token's k and v
    are written into ``cache`` in place, and the same tensors are returned.
    With a ``window`` shorter than the cache plus one the cache is a ring
    buffer: slot ``pos % S``, each entry rope'd at its absolute position.
    Attention runs over the filled prefix ``[:n]`` of the cache, a view:
    n = pos + 1, or min(pos + 1, S) for the ring. JAX masks the slots past
    ``pos`` to -1e30 instead; their weights exp(-1e30 - m) are exactly 0, so
    the two agree.
    """
    B = x.shape[0]
    S = cache["k"].shape[1]
    pos = int(pos)
    q, k, v = _qkv(p, x, cfg, torch.full((1,), pos, device=x.device))
    if window and window < S + 1:
        slot, n = pos % S, min(pos + 1, S)
    else:
        if not 0 <= pos < S:
            raise ValueError(f"gqa_decode: position {pos} outside a cache "
                             f"of {S}")
        slot, n = pos, pos + 1
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    out = flash_attention_gqa(q, cache["k"][:, :n], cache["v"][:, :n],
                              _scale(cfg), causal=False)
    return out.reshape(B, 1, -1) @ p["w_o"], cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, seq: int, window: int = 0,
                   device="cuda"):
    """Zero k/v caches (batch, min(seq, window) or seq, Hkv, hd)."""
    S = min(seq, window) if window else seq
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}
