"""Launcher of the CUDA flash attention (``csrc/flash_attention.cu``).

The port's counterpart of the Pallas ``flash_attention_pallas``. Its plain
versions are in :mod:`repro_torch.kernels.flash_attention.ref`. It takes
the model's layout, q (B, T, H, D) and k, v (B, S, Hkv, D), as strided
views whose last dimension is contiguous (a decode passes the cache prefix
``k_all[:, :n]`` with no copy), and writes a new contiguous (B, T, H, D).
A sliding ``window`` w > 0 (causal self-attention, T == S) limits query
row i to keys i - w < j <= i, and the kernels skip the key tiles outside
that band.

Three kernels, chosen by T, dtype and D only (:func:`path_of`):
``"tile_tc"`` (T > 1, bfloat16, D 64 or 128: ``wgmma`` products fed by a
TMA ring, the softmax weights rounded to bfloat16 for the P.V product, as
the plain version rounds them to v's dtype; its plain twin is
``ref.flash_attention_tc_torch``), ``"tile_simt"`` (T > 1 otherwise:
float32 products on the CUDA cores, weights kept in float32) and
``"decode_split"`` (T = 1: the keys split over blocks, all query heads of
a KV head in one block, partial states merged in split order by a second
launch; its plain twin is ``ref.flash_decode_split_torch``). Each call
counts once in ``.launches`` and once under its path in
``.launches_by_path``.
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .ref import check_window, split_chunk

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128)
_INT_MAX = 2 ** 31 - 1
PATHS = ("tile_tc", "tile_simt", "decode_split")
# The split decode's grid: about two waves of the H100's 132 SMs, each
# split at least SPLIT_MIN_KEYS keys; a block takes up to DECODE_HEADS
# query heads of one KV head.
DECODE_BLOCKS = 2 * 132
SPLIT_MIN_KEYS = 128
DECODE_HEADS = 8


def geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             what: str = "flash_attention_cuda") -> tuple:
    """The kernel's shape and stride arguments for q (B, T, H, D) and k, v
    (B, S, Hkv, D): (B, T, S, H, Hkv, D, q strides (b, t, h), k strides,
    v strides), in elements. Raises on what the kernel does not take."""
    if q.dtype not in _BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32/bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: bad shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if min(B, T, S, H, Hkv) < 1 or H % Hkv or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: needs T, S >= 1, H a multiple of Hkv and "
                         f"0 < D <= {MAX_HEAD_DIM}, got {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    if B * H * -(-T // 64) > _INT_MAX or max(T, S) > _INT_MAX:
        raise ValueError(f"{what}: too many blocks for {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    return (B, T, S, H, Hkv, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3])


def path_of(q: torch.Tensor) -> str:
    """The kernel a call with query q (B, T, H, D) takes."""
    if q.shape[1] == 1:
        return "decode_split"
    if q.dtype == torch.bfloat16 and q.shape[3] in TC_HEAD_DIMS:
        return "tile_tc"
    return "tile_simt"


def check_tma(q, k, v, what: str = "flash_attention_cuda") -> None:
    """Raise unless q, k and v start on 16-byte boundaries and every
    stride is a multiple of 16 bytes, as the tensor-core tile kernel's TMA
    tensor maps need."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        esz = t.element_size()
        if t.data_ptr() % 16 or any(s * esz % 16 for s in t.stride()[:3]):
            raise ValueError(f"{what}: the tensor-core kernel needs {name} "
                             f"16-byte aligned with strides of 16-byte "
                             f"multiples, got {t.data_ptr() % 16} bytes off "
                             f"and strides {t.stride()}")


def decode_splits(n: int, blocks: int) -> int:
    """Splits of a decode over ``n`` keys whose grid has ``blocks`` blocks
    per split: about ``DECODE_BLOCKS`` blocks in all, each split at least
    ``SPLIT_MIN_KEYS`` keys, at least one split."""
    return max(1, min(round(DECODE_BLOCKS / blocks), n // SPLIT_MIN_KEYS))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool,
                         window: int = 0) -> torch.Tensor:
    """Attention of q (B, T, H, D) over k, v (B, S, Hkv, D) on the card ->
    (B, T, H, D) in q's dtype, within a sliding ``window`` when it is
    positive. Counts each call in ``.launches`` and under its path in
    ``.launches_by_path``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda needs q, k, v on one "
                             f"CUDA device, got {name} on {t.device}")
    g = geometry(q, k, v)
    check_window(q.shape[1], k.shape[1], causal, window,
                 "flash_attention_cuda")
    path = path_of(q)
    if path == "tile_tc":
        check_tma(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if path == "decode_split":
            B, _, S, H, Hkv, D = g[:6]
            n = 1 if causal else S      # the one query sits at position 0
            n_split = decode_splits(n, B * Hkv * -(-(H // Hkv)
                                                  // DECODE_HEADS))
            ml = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                             device=q.device)
            acc = torch.empty((B, H, n_split, D), dtype=torch.float32,
                              device=q.device)
            err = lib.soar_flash_decode(
                *ptrs, _BF16[q.dtype], B, n, H, Hkv, D, q.stride(0),
                q.stride(2), *k.stride()[:3], *v.stride()[:3],
                out.stride(0), out.stride(2), float(scale), n_split,
                split_chunk(n, n_split), ml.data_ptr(), acc.data_ptr(),
                stream_of(q))
        elif path == "tile_tc":
            err = lib.soar_flash_tile_tc(
                *ptrs, *g, *out.stride()[:3], int(causal), int(window),
                float(scale), stream_of(q))
        else:
            err = lib.soar_flash_tile(
                *ptrs, _BF16[q.dtype], *g, *out.stride()[:3], int(causal),
                int(window), float(scale), stream_of(q))
    check(err, f"flash attention launch ({path})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_path[path] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_path = dict.fromkeys(PATHS, 0)
