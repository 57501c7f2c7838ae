"""Plain torch versions of flash attention: masked softmax attention.

``flash_attention_torch`` is the twin of the JAX oracle
``flash_attention_ref`` on the (BH, T, D) layout. ``sdpa`` is the plain
grouped-query attention of the JAX model's ``sdpa`` on the model's layout
(``models.attention`` trains with it), and ``flash_attention_gqa_torch``
is it under the kernel's signature. All build the full masked scores in
float32, softmax them, cast the weights to ``v``'s dtype and take the
product; the causal mask aligns query and key positions at 0. With a
sliding window w, ``flash_attention_gqa_torch`` takes the query rows in
blocks and each block only the keys of its band, so the scores never
exceed (rows, rows + w) per head; keys outside the band would get weight
exp(-1e30 - m) = 0 exactly. The CUDA kernel ``csrc/flash_attention.cu``
agrees with them to rounding: it keeps the weights in float32 and sums in
another order.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# query rows per block of the windowed plain version (at least the window)
WINDOW_ROWS = 256


def _mask(t: int, s: int, device, window: int = 0,
          offset: int = 0) -> torch.Tensor:
    """(T, S): query row i (at position i + offset) sees keys 0..i + offset,
    and only keys > i + offset - window when ``window`` > 0."""
    qpos = torch.arange(t, device=device)[:, None] + offset
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def check_window(t: int, s: int, causal: bool, window: int,
                 what: str) -> None:
    """Raise unless ``window`` is 0, or positive on causal
    self-attention (T == S)."""
    if window < 0 or (window and (not causal or t != s)):
        raise ValueError(f"{what}: a sliding window needs causal attention "
                         f"with T == S, got window {window}, causal "
                         f"{causal}, T {t}, S {s}")


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


def flash_attention_gqa_torch(q, k, v, scale, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, Hkv, D) -> (B, T, H, D); with a
    ``window`` w > 0 (causal, T == S) row i sees keys i - w < j <= i."""
    t, s = q.shape[1], k.shape[1]
    check_window(t, s, causal, window, "flash_attention_gqa_torch")
    if not window:
        mask = _mask(t, s, q.device)[None] if causal else None
        return sdpa(q, k, v, mask, scale)
    rows = max(window, WINDOW_ROWS)
    out = []
    for r0 in range(0, t, rows):          # rows [r0, r1), keys [k0, r1)
        r1 = min(t, r0 + rows)
        k0 = max(0, r0 - window + 1)
        mask = _mask(r1 - r0, r1 - k0, q.device, window, r0 - k0)
        out.append(sdpa(q[:, r0:r1], k[:, k0:r1], v[:, k0:r1], mask[None],
                        scale))
    return torch.cat(out, 1)
