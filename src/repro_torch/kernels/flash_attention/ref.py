"""Plain torch versions of flash attention: masked softmax attention.

``flash_attention_torch`` is the twin of the JAX oracle
``flash_attention_ref`` on the (BH, T, D) layout. ``sdpa`` is the plain
grouped-query attention of the JAX model's ``sdpa`` on the model's layout
(``models.attention`` trains with it), and ``flash_attention_gqa_torch``
is it under the kernel's signature. All build the full masked scores in
float32, softmax them, cast the weights to ``v``'s dtype and take the
product; the causal mask aligns query and key positions at 0. The CUDA
kernel ``csrc/flash_attention.cu`` agrees with them to rounding: it keeps
the weights in float32 and sums in another order.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(t: int, s: int, device) -> torch.Tensor:
    """(T, S): query row i sees keys 0..i."""
    return (torch.arange(s, device=device)[None, :]
            <= torch.arange(t, device=device)[:, None])


def flash_attention_torch(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: (BH, T, D); k, v: (BH, S, D) -> (BH, T, D), scale 1/sqrt(D)."""
    t, d = q.shape[1], q.shape[2]
    s = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("btd,bsd->bts", q, k).to(torch.float32) * scale
    if causal:
        logits = torch.where(_mask(t, s, q.device)[None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", w.to(v.dtype), v)


def sdpa(q, k, v, mask, scale) -> torch.Tensor:
    """q: (B,T,H,Dq) k: (B,S,Hkv,Dq) v: (B,S,Hkv,Dv); GQA by head grouping
    (query head h reads KV head h // (H / Hkv)). mask: (B or 1, T, S)
    bool, or None for every key."""
    B, T, H, Dq = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, Dq)
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k).to(torch.float32) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", w, v)
    return out.reshape(B, T, H, -1)


def flash_attention_gqa_torch(q, k, v, scale, causal: bool = True
                              ) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, Hkv, D) -> (B, T, H, D)."""
    mask = _mask(q.shape[1], k.shape[1], q.device)[None] if causal else None
    return sdpa(q, k, v, mask, scale)
