"""Plain torch version of the per-row top-k by magnitude.

What the JAX package's oracle ``topk_compress_ref`` computes with
``lax.top_k``: the k largest ``|x|`` of each row, taken in float32, in
descending order with the lower index first among equal magnitudes, NaN
above every number. A stable descending sort gives exactly that order. The
CUDA kernel ``csrc/topk_compress.cu`` agrees with it bit for bit.
"""
from __future__ import annotations

import torch


def _sorted_mag(x: torch.Tensor, k: int):
    mag = x.abs().to(torch.float32)
    s = torch.sort(mag, dim=1, descending=True, stable=True)
    return s.values[:, :k], s.indices[:, :k]


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def topk_compress_torch(x: torch.Tensor, k: int):
    """x (R, D) -> (values (R, k) in x's dtype, indices (R, k) int32)."""
    _, idx = _sorted_mag(x, k)
    # gathered as raw bits: a bfloat16 gather on the CPU rewrites NaNs
    bits = _BITS.get(x.dtype, x.dtype)
    vals = torch.gather(x.view(bits), 1, idx).view(x.dtype)
    return vals, idx.to(torch.int32)


def topk_threshold_torch(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest ``|x|`` of each row of (R, D), float32 (R,)."""
    return _sorted_mag(x, k)[0][:, k - 1].contiguous()


# -- the CUDA kernel's steps, on the CPU ---------------------------------------
#
# What ``csrc/topk_compress.cu`` does, step by step, for the tests to hold
# against the stable sort above: the radix select over 11-bit digits of
# the key (bits 30-20, 19-9, 8-0; bfloat16 stops after two), its candidate
# buffer and overflow, the compaction in index order and the stable LSD
# order on ~key in three 11-bit passes, a pass skipped when all k keys share
# its digit.

#: Values of the longest row whose select the kernel runs in one launch
#: (one block a row, its keys in registers).
SMALL_ROW = 16_384
_PASSES = ((20, 2048, 0x00000000), (9, 2048, 0xfff00000),
           (0, 512, 0xfffffe00))    # (shift, bins, bits fixed before)


def magnitude_keys(x: torch.Tensor) -> torch.Tensor:
    """uint32 keys of |x| as int64 (R, D): |x|'s float32 bits, every NaN as
    0x7fc00000 (above +inf); bfloat16 widened by its bits << 16."""
    if x.dtype == torch.bfloat16:
        bits = (x.view(torch.int16).to(torch.int64) & 0xffff) << 16
    else:
        bits = x.to(torch.float32).view(torch.int32).to(torch.int64)
    b = bits & 0x7fffffff
    return torch.where(b > 0x7f800000, torch.full_like(b, 0x7fc00000), b)


def candidate_cap(d: int, cap: int | None = None) -> int:
    """Keys a row's candidate buffer holds: the kernel's d // 16 (``cap``
    in its place lets a test overflow it at a small d), rounded down to a
    multiple of 4; 0 for a short row, whose select has no buffer."""
    return 0 if d <= SMALL_ROW else (d // 16 if cap is None else cap) // 4 * 4


def topk_select_radix_torch(x: torch.Tensor, k: int, cap: int | None = None):
    """The kernel's select on each row of (R, D): a list of dicts with the
    k-th largest key ``prefix``, ``n_gt`` = #(key > prefix), ``n_eq`` =
    #(key == prefix), and ``from_candidates``, whether the last pass read
    the candidate buffer (pass 1's bin fit ``candidate_cap``) rather than
    the row."""
    n_pass = 2 if x.dtype == torch.bfloat16 else 3
    room = 0 if n_pass == 2 else candidate_cap(x.shape[1], cap)
    out = []
    for keys in magnitude_keys(x):
        prefix, rem, n_gt, n_eq = 0, k, 0, 0
        pool, from_cand = keys, False
        for p in range(n_pass):
            shift, bins, fixed = _PASSES[p]
            sel = pool[(pool & fixed) == prefix]
            hist = torch.bincount((sel >> shift) & (bins - 1), minlength=bins)
            above = hist.flip(0).cumsum(0).flip(0) - hist   # counts above b
            b = int(((above < rem) & (above + hist >= rem)).nonzero()[0, 0])
            if p == 0 and 0 < int(hist[b]) <= room:
                # pass 1 writes the bin's keys to the buffer, pass 2 reads it
                pool = keys[(keys & 0xfff00000) == b << shift]
                from_cand = True
            prefix |= b << shift
            rem -= int(above[b])
            n_gt += int(above[b])
            n_eq = int(hist[b])
        out.append(dict(prefix=prefix, n_gt=n_gt, n_eq=n_eq,
                        from_candidates=from_cand))
    return out


def topk_threshold_radix_torch(x: torch.Tensor, k: int,
                               cap: int | None = None) -> torch.Tensor:
    """The threshold from :func:`topk_select_radix_torch`: float32 (R,)."""
    bits = [s["prefix"] for s in topk_select_radix_torch(x, k, cap)]
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def topk_order_lsd_torch(keys: torch.Tensor, idx: torch.Tensor):
    """The kernel's order: a stable LSD sort of (key, index) pairs (1-D,
    in index order) on ~key over three 11-bit digits, each a stable pass
    by one digit; a pass where every key has the same digit is skipped.
    Returns (keys, indices, the passes that ran)."""
    ran = []
    for p in range(3):
        d = ((~keys & 0xffffffff) >> (11 * p)) & 2047
        if bool((d == d[0]).all()):
            ran.append(False)
            continue
        order = torch.sort(d, stable=True).indices
        keys, idx = keys[order], idx[order]
        ran.append(True)
    return keys, idx, ran


def topk_compress_radix_torch(x: torch.Tensor, k: int,
                              cap: int | None = None):
    """The kernel's top-k from its steps: select, compaction in index order
    (every key above the threshold and the first k - n_gt equal to it),
    the LSD order, the gather. Same results as :func:`topk_compress_torch`."""
    keys_all = magnitude_keys(x)
    bits = _BITS.get(x.dtype, x.dtype)
    vals, idxs = [], []
    for r, st in enumerate(topk_select_radix_torch(x, k, cap)):
        keys = keys_all[r]
        t, need = st["prefix"], k - st["n_gt"]
        eq = keys == t
        take = (keys > t) | (eq & (eq.cumsum(0) <= need))
        idx = take.nonzero()[:, 0]
        _, idx, _ = topk_order_lsd_torch(keys[idx], idx)
        vals.append(x[r].view(bits)[idx].view(x.dtype))
        idxs.append(idx.to(torch.int32))
    return torch.stack(vals), torch.stack(idxs)
