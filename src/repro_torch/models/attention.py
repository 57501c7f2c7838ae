"""Attention: the port of the JAX package's ``models/attention.py``, GQA
(with qk-norm and sliding windows) and MLA (multi-head latent attention,
DeepSeek-V2 / MiniCPM3), for training, prefill and decode.

Training is spelled in torch ops as the JAX model spells it in jnp:
``sdpa`` (the kernel's plain version, ``kernels.flash_attention.ref``)
builds the masked (T, S) scores and ``sdpa_blocked`` is the
online-softmax dataflow over (query block, key block) tiles that long
sequences take; autograd runs through them. Prefill and decode run the
flash-attention kernel (``kernels.flash_attention.ops``; its plain version
on CPU tensors), windowed layers with the kernel's sliding window. Shapes:
x (B, T, d); q (B, T, H, hd); k, v and the cache (B, S, Hkv, hd). MLA
keeps a latent cache, ckv (B, S, r) and the shared rope key kr (B, S,
rd); its keys are qk_nope_dim + qk_rope_dim wide and its values
v_head_dim, so its scale is 1 / sqrt(qk_nope_dim + qk_rope_dim), not 1 /
sqrt(hd). Its prefill runs the flash kernel with values narrower than
keys, and its absorbed decode the latent decode kernel
(``ops.flash_mla_decode``) over the cache.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.flash_attention.ops import (flash_attention_gqa,
                                           flash_decode_lse,
                                           flash_mla_decode)
from ..kernels.flash_attention.ref import sdpa  # noqa: F401  (re-exported)
from ..parallel import layer_gather as lg
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
    """q (B, T, H, hd), k and v (B, T, Hkv, hd), rope'd; the head counts
    those of the projections' columns (split over ``model``, a rank's
    heads)."""
    B, T, _ = x.shape
    hd = cfg.hd
    q = (x @ p["w_q"]).reshape(B, T, -1, hd)
    k = (x @ p["w_k"]).reshape(B, T, -1, hd)
    v = (x @ p["w_v"]).reshape(B, T, -1, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)   # (T, hd/2)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _scale(d: int) -> float:
    """1 / sqrt(d) as the JAX model rounds it (float32), as a Python float
    computed on the host: a decode step never waits for the card."""
    return float(np.float32(1) / np.sqrt(np.float32(d)))


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
        out = flash_attention_gqa(q, k, v, _scale(cfg.hd), causal=causal,
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

    Where the ``model`` ranks of a mesh hold blocks of the cache's
    positions (``layer_gather.decode_block``: this rank's from ``start``),
    ``pos`` is the sequence's own: the rank whose block holds it writes the
    token's k/v, each rank attends over the filled part of its block, n =
    clamp(pos + 1 - start, 0, S), with the split decode's log-sum-exp (a
    rank with n = 0 launches nothing), and the ranks' outputs merge by
    log-sum-exp (``layer_gather.combine``).
    """
    B = x.shape[0]
    S = cache["k"].shape[1]
    pos = int(pos)
    q, k, v = _qkv(p, x, cfg, torch.full((1,), pos, device=x.device))
    start = None if window and window < S + 1 else lg.decode_block(S)
    if start is not None:
        if 0 <= pos - start < S:
            cache["k"][:, pos - start] = k[:, 0]
            cache["v"][:, pos - start] = v[:, 0]
        out = block_decode(q, cache["k"], cache["v"], pos + 1 - start,
                           _scale(cfg.hd))
        return out.reshape(B, 1, -1) @ p["w_o"], cache
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
                              _scale(cfg.hd), causal=False)
    return out.reshape(B, 1, -1) @ p["w_o"], cache


def block_decode(q, k, v, n: int, scale) -> torch.Tensor:
    """q (B, 1, H, D) over the first n positions (clamped to [0, S]) of
    this rank's block of a cache, k (B, S, Hkv, D), v (B, S, Hkv, Dv), the
    ``model`` ranks' blocks then merged by log-sum-exp
    (``layer_gather.combine``) -> (B, 1, H, Dv). The split decode with its
    merge's lse; a rank with no filled position launches nothing."""
    n = min(max(n, 0), k.shape[1])
    out, lse = (flash_decode_lse(q, k[:, :n], v[:, :n], scale) if n
                else (None, None))
    return lg.combine(out, lse, q.shape[:3] + v.shape[3:], q.dtype,
                      q.device)


def gqa_cache_spec(cfg: ModelConfig, batch: int, seq: int, window: int = 0,
                   device="cuda"):
    """Zero k/v caches (batch, min(seq, window) or seq, Hkv, hd)."""
    S = min(seq, window) if window else seq
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3): latent-compressed KV
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig):
    """The JAX tree's leaves: ``w_dq``, ``q_norm`` and ``w_uq`` (or ``w_q``
    without ``q_lora_rank``), ``w_dkv``, ``kv_norm``, ``w_ukv``, ``w_o``."""
    d, H = cfg.d_model, cfg.n_heads
    nd, rd, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    dt = dtype_of(cfg)
    p = {}
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(gen, (d, cfg.q_lora_rank), dt)
        p["q_norm"] = torch.ones((cfg.q_lora_rank,), dtype=dt,
                                 device=gen.device)
        p["w_uq"] = dense_init(gen, (cfg.q_lora_rank, H * (nd + rd)), dt)
    else:
        p["w_q"] = dense_init(gen, (d, H * (nd + rd)), dt)
    p["w_dkv"] = dense_init(gen, (d, r + rd), dt)   # latent + shared k_rope
    p["kv_norm"] = torch.ones((r,), dtype=dt, device=gen.device)
    p["w_ukv"] = dense_init(gen, (r, H * (nd + vd)), dt)
    p["w_o"] = dense_init(gen, (H * vd, d), dt)
    return p


def _mla_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(qk_nope_dim + qk_rope_dim), the width of MLA's keys."""
    return _scale(cfg.qk_nope_dim + cfg.qk_rope_dim)


def _mla_q(p, x, cfg: ModelConfig, positions):
    """(q_nope (B, T, H, nd), q_rope (B, T, H, rd)), q_rope rope'd."""
    B, T, _ = x.shape
    H, nd, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        ql = rms_head_norm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
        q = (ql @ p["w_uq"]).reshape(B, T, H, nd + rd)
    else:
        q = (x @ p["w_q"]).reshape(B, T, H, nd + rd)
    cos, sin = rope_tables(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q[..., nd:], cos[None, :, None, :],
                        sin[None, :, None, :])
    return q[..., :nd], q_rope


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """(ckv (B, T, r) normed, kr (B, T, rd) rope'd: one head for all)."""
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    ckv_kr = x @ p["w_dkv"]
    ckv = rms_head_norm(p["kv_norm"], ckv_kr[..., :r], cfg.norm_eps)
    cos, sin = rope_tables(positions, rd, cfg.rope_theta)
    return ckv, apply_rope(ckv_kr[..., r:], cos[None], sin[None])


def _mla_full(q_nope, q_rope, k_nope, kr):
    """The shared rope head folded into every head's key: (q_nope |
    q_rope) and (k_nope | kr), one dot over the concatenated width equal
    to the two dots summed."""
    B, T, H, _ = k_nope.shape
    k_rope = kr[:, :, None, :].expand(B, T, H, kr.shape[-1])
    return (torch.cat([q_nope, q_rope], -1), torch.cat([k_nope, k_rope], -1))


def mla_forward(p, x, cfg: ModelConfig, causal: bool = True,
                mode: str = "train"):
    """Full-sequence MLA with the keys and values materialised. Returns
    (out, {"ckv", "kr"}).

    ``mode="train"`` spells the JAX function's two branches, which round
    differently in bfloat16: ``sdpa_blocked`` over the concatenated keys
    where the sequence tiles, else the two-einsum scores ``q_nope .
    k_nope + q_rope . kr`` summed before the scale. ``mode="prefill"``
    runs the flash kernel on the concatenated q and k, 96 wide at
    minicpm3, and the values ``kv[..., nd:]``, a strided view 64 wide."""
    B, T, _ = x.shape
    H, nd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    positions = torch.arange(T, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, kr = _mla_latent(p, x, cfg, positions)
    kv = (ckv @ p["w_ukv"]).reshape(B, T, H, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    scale = _mla_scale(cfg)
    if mode == "prefill":
        q_full, k_full = _mla_full(q_nope, q_rope, k_nope, kr)
        out = flash_attention_gqa(q_full, k_full, v, scale, causal=causal)
    elif mode != "train":
        raise ValueError(f"mla_forward: mode {mode!r} is train or prefill")
    elif _pick_block(T, T):
        q_full, k_full = _mla_full(q_nope, q_rope, k_nope, kr)
        out = sdpa_blocked(q_full, k_full, v, scale, causal=causal)
    else:
        logits = (torch.einsum("bthd,bshd->bhts", q_nope, k_nope)
                  + torch.einsum("bthd,bsd->bhts", q_rope, kr)).to(
                      torch.float32)
        mask = (causal_mask(T, T, device=x.device) if causal else
                torch.ones((T, T), dtype=torch.bool, device=x.device))
        logits = torch.where(mask, logits * scale, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bshd->bthd", w, v)
    out = out.reshape(B, T, H * vd) @ p["w_o"]
    return out, {"ckv": ckv, "kr": kr}


def mla_decode(p, x, cache, pos: int, cfg: ModelConfig):
    """Single-token decode over the latent cache ckv (B, S, r), kr (B, S,
    rd). As ``gqa_decode``, the token's latent is written into ``cache``
    in place at ``pos`` (a host int) and the same tensors are returned;
    attention runs over the filled prefix ``[:pos + 1]``, views. With
    ``cfg.decode_absorb`` W_uk is absorbed into the query (q_lat = q_nope
    W_uk) and the latent decode kernel attends every head over the cache,
    the context mapped back by W_uv; otherwise k_nope and v are
    materialised from the cache prefix and the split decode runs on keys
    nd + rd wide and values vd wide."""
    B = x.shape[0]
    S = cache["ckv"].shape[1]
    pos = int(pos)
    if not 0 <= pos < S:
        raise ValueError(f"mla_decode: position {pos} outside a cache of "
                         f"{S}")
    H, nd, rd, vd, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)   # (B,1,H,nd),(B,1,H,rd)
    ckv_t, kr_t = _mla_latent(p, x, cfg, positions)  # (B,1,r),(B,1,rd)
    cache["ckv"][:, pos] = ckv_t[:, 0]
    cache["kr"][:, pos] = kr_t[:, 0]
    ckv, kr = cache["ckv"][:, :pos + 1], cache["kr"][:, :pos + 1]
    w_ukv = p["w_ukv"].reshape(r, H, nd + vd)
    w_uk, w_uv = w_ukv[..., :nd], w_ukv[..., nd:]
    scale = _mla_scale(cfg)
    if cfg.decode_absorb:
        q_lat = torch.einsum("bthd,rhd->bthr", q_nope, w_uk)   # (B,1,H,r)
        ctx_lat = flash_mla_decode(q_lat, q_rope, ckv, kr, scale)
        out = torch.einsum("bthr,rhd->bthd", ctx_lat, w_uv)
    else:
        k_nope = torch.einsum("bsr,rhd->bshd", ckv, w_uk)
        v = torch.einsum("bsr,rhd->bshd", ckv, w_uv)
        q_full, k_full = _mla_full(q_nope, q_rope, k_nope, kr)
        out = flash_attention_gqa(q_full, k_full, v, scale, causal=False)
    return out.reshape(B, 1, H * vd) @ p["w_o"], cache


def mla_cache_spec(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Zero latent caches: ckv (batch, seq, r), kr (batch, seq, rd)."""
    dt = dtype_of(cfg)
    return {"ckv": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dt,
                               device=device),
            "kr": torch.zeros((batch, seq, cfg.qk_rope_dim), dtype=dt,
                              device=device)}
