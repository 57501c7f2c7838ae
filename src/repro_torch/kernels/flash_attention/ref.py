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
exp(-1e30 - m) = 0 exactly. The CUDA kernels ``csrc/flash_attention.cu``
agree with them to rounding. Two plain versions repeat a kernel's own
arithmetic for the tests: ``flash_attention_tc_torch`` that of the
tensor-core tile kernel (online softmax over 128-key tiles in base 2,
masked scores -inf, the weights rounded to bfloat16 before P.V, l summed
from the float32 weights) and ``flash_decode_split_torch`` that of the split decode
(float32 partial states per split of keys, merged in split order);
``flash_mla_decode_torch`` is the float32 latent-attention decode
kernel's (``flash_mla_decode``: all heads over one latent cache, scores
``q_lat . ckv + q_rope . kr``, values ``ckv``), which splits and merges as
the split decode does; ``flash_mla_decode_tc_torch`` is the bfloat16
tensor-core latent decode's (64-key tiles in base 2, the weights rounded
to bfloat16 before P.ckv, the splits merged in base 2). Every version
takes a value width Dv of its own, at most the key width D (MLA: keys 96
wide, values 64).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# query rows per block of the windowed plain version (at least the window)
WINDOW_ROWS = 256
TC_KEYS = 128                 # keys of the tensor-core kernel's K/V tile
SPLIT_ALIGN = 64              # a decode split is a multiple of 64 keys
LOG2E = 1.4426950408889634


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
    """q: (B, T, H, D); k: (B, S, Hkv, D), v: (B, S, Hkv, Dv) -> (B, T, H,
    Dv); with a
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


def flash_attention_tc_torch(q, k, v, scale, causal: bool = True,
                             window: int = 0) -> torch.Tensor:
    """q: (B, T, H, D); k: (B, S, Hkv, D), v: (B, S, Hkv, Dv) bfloat16 ->
    (B, T, H, Dv), in the tensor-core tile kernel's arithmetic: scores s =
    q . k in float32, masked to -inf; per 128-key tile the running max m
    of s c (c the float32 scale * log2(e); m from -1e30), alpha = exp2(m -
    m_new), p = exp2(s c - m_new) rounded once (the kernel's FMA), l = l
    alpha + sum(p) in float32, acc = acc alpha + bf16(p) . v in float32; o
    = acc / max(l, 1e-30) in q's dtype."""
    B, T, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    check_window(T, S, causal, window, "flash_attention_tc_torch")
    c = (torch.tensor(float(scale), dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32)).to(q.device)
    qf = q.to(torch.float32).reshape(B, T, Hkv, G, D)
    m = torch.full((B, Hkv, G, T), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, T, Dv), dtype=torch.float32,
                      device=q.device)
    rows = torch.arange(T, device=q.device)[:, None]
    for k0 in range(0, S, TC_KEYS):
        k1 = min(S, k0 + TC_KEYS)
        sc = torch.einsum("bthgd,bshd->bhgts", qf,
                          k[:, k0:k1].to(torch.float32))
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        keep = torch.ones((T, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            keep &= kpos <= rows
        if window:
            keep &= kpos > rows - window
        sc = torch.where(keep, sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        y = sc.to(torch.float64) * c.to(torch.float64) - m_new[..., None].to(
            torch.float64)
        p = torch.exp2(y.to(torch.float32))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgts,bshd->bhgtd", p.to(torch.bfloat16).to(torch.float32),
            v[:, k0:k1].to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dv).to(q.dtype)


def split_chunk(n: int, n_split: int) -> int:
    """Keys of each of ``n_split`` decode splits over ``n`` keys: the 64-key
    tiles shared out evenly; trailing splits may come out empty."""
    tiles = -(-n // SPLIT_ALIGN)
    return -(-tiles // n_split) * SPLIT_ALIGN


def flash_decode_split_torch(q, k, v, scale, n_split: int,
                             lse: bool = False):
    """q: (B, 1, H, D); k: (B, n, Hkv, D), v: (B, n, Hkv, Dv) -> (B, 1, H,
    Dv), in the split decode's arithmetic: split s takes keys [s c, (s +
    1) c), c = ``split_chunk(n, n_split)``, and keeps its float32 max m_s,
    sum l_s and unnormalised accumulator (an empty split m = -1e30, l =
    0); the splits are merged in order: o = sum_s acc_s e_s / max(sum_s
    l_s e_s, 1e-30), e_s = exp(m_s - max m). With ``lse`` -> (o, lse),
    lse (B, H) float32 = max m + log(sum_s l_s e_s), as the merge writes
    it."""
    B, _, H, D = q.shape
    n, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hkv
    chunk = split_chunk(n, n_split)
    qf = q.to(torch.float32).reshape(B, Hkv, G, D)
    parts = []
    for s in range(n_split):
        lo, hi = s * chunk, min(n, (s + 1) * chunk)
        if lo >= hi:
            m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
            parts.append((m, torch.zeros_like(m),
                          torch.zeros((B, Hkv, G, Dv), device=q.device)))
            continue
        x = torch.einsum("bhgd,bshd->bhgs", qf,
                         k[:, lo:hi].to(torch.float32)) * scale
        m = x.amax(-1)
        p = torch.exp(x - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum(
            "bhgs,bshd->bhgd", p, v[:, lo:hi].to(torch.float32))))
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(mm)
    out = torch.zeros((B, Hkv, G, Dv), device=q.device)
    for m, ls, acc in parts:
        e = torch.exp(m - mm)
        den = den + ls * e
        out = out + acc * e[..., None]
    out = out / torch.clamp(den, min=1e-30)[..., None]
    out = out.reshape(B, 1, H, Dv).to(q.dtype)
    if lse:
        return out, (mm + torch.log(den)).reshape(B, H)
    return out


def mla_keys(ckv, kr) -> torch.Tensor:
    """The latent cache as one (B, n, 1, r + rd) key head: ckv | kr."""
    return torch.cat([ckv, kr], -1)[:, :, None]


def flash_mla_decode_torch(q_lat, q_rope, ckv, kr, scale,
                           n_split: int) -> torch.Tensor:
    """q_lat (B, 1, H, r), q_rope (B, 1, H, rd), ckv (B, n, r), kr (B, n,
    rd) -> ctx_lat (B, 1, H, r) in q_lat's dtype, in the latent decode
    kernel's arithmetic: every head over the one latent cache, scores
    (q_lat . ckv + q_rope . kr) * scale in float32, values ckv; the keys
    split and merged as ``flash_decode_split_torch`` does (one key head of
    width r + rd, values its first r columns)."""
    q = torch.cat([q_lat, q_rope], -1)
    return flash_decode_split_torch(q, mla_keys(ckv, kr), ckv[:, :, None],
                                    scale, n_split)


def flash_mla_decode_tc_torch(q_lat, q_rope, ckv, kr, scale,
                              n_split: int) -> torch.Tensor:
    """q_lat (B, 1, H, r), q_rope (B, 1, H, rd), ckv (B, n, r), kr (B, n,
    rd) -> ctx_lat (B, 1, H, r) in q_lat's dtype, in the tensor-core latent
    decode kernel's arithmetic: scores s = q_lat . ckv + q_rope . kr in
    float32; split i takes keys [i c, (i + 1) c), c = ``split_chunk(n,
    n_split)``, in 64-key tiles: the running max m of s x (x the float32
    scale * log2(e); m from -1e30), alpha = exp2(m - m_new), p = exp2(s x
    - m_new) rounded once (the kernel's FMA), l = l alpha + sum(p) in
    float32, acc = acc alpha + bf16(p) . ckv in float32 (keys past the
    split -inf: weight 0). The splits merge in order in base 2: o = sum_s
    acc_s e_s / max(sum_s l_s e_s, 1e-30), e_s = exp2(m_s - max m) (an
    empty split m = -1e30, l = 0)."""
    B, _, H, r = q_lat.shape
    n = ckv.shape[1]
    dev = q_lat.device
    chunk = split_chunk(n, n_split)
    x = (torch.tensor(float(scale), dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32)).to(dev)
    q = torch.cat([q_lat, q_rope], -1)[:, 0].to(torch.float32)   # (B, H, w)
    pad = n_split * chunk - n             # every split chunk keys, masked
    keys = torch.nn.functional.pad(torch.cat([ckv, kr], -1).to(
        torch.float32), (0, 0, 0, pad))
    vals = torch.nn.functional.pad(ckv.to(torch.float32), (0, 0, 0, pad))
    keys = keys.reshape(B, n_split, chunk, -1)
    vals = vals.reshape(B, n_split, chunk, r)
    m = torch.full((B, n_split, H), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, n_split, H, r), dtype=torch.float32, device=dev)
    split_lo = torch.arange(n_split, device=dev)[:, None] * chunk
    for k0 in range(0, chunk, SPLIT_ALIGN):
        k1 = k0 + SPLIT_ALIGN
        sc = torch.einsum("bhw,bskw->bshk", q, keys[:, :, k0:k1])
        kpos = split_lo + torch.arange(k0, k1, device=dev)[None, :]
        sc = torch.where((kpos < n)[None, :, None, :], sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1) * x)
        alpha = torch.exp2(m - m_new)
        y = sc.to(torch.float64) * x.to(torch.float64) - m_new[..., None].to(
            torch.float64)
        p = torch.exp2(y.to(torch.float32))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bshk,bskr->bshr", p.to(torch.bfloat16).to(torch.float32),
            vals[:, :, k0:k1])
        m = m_new
    e = torch.exp2(m - m.amax(1, keepdim=True))
    den = torch.zeros((B, H), dtype=torch.float32, device=dev)
    out = torch.zeros((B, H, r), dtype=torch.float32, device=dev)
    for s in range(n_split):              # in split order
        den = den + l[:, s] * e[:, s]
        out = out + acc[:, s] * e[:, s, :, None]
    out = out / torch.clamp(den, min=1e-30)[..., None]
    return out[:, None].to(q_lat.dtype)
