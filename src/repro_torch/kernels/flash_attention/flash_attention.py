"""Launcher of the CUDA flash attention (``csrc/flash_attention.cu``).

The port's counterpart of the Pallas ``flash_attention_pallas``. Its plain
versions are in :mod:`repro_torch.kernels.flash_attention.ref`. It takes
the model's layout, q (B, T, H, D), k (B, S, Hkv, D) and v (B, S, Hkv, Dv)
with a value width Dv <= D of its own (MLA: keys 96 wide, values 64), as
strided views whose last dimension is contiguous (a decode passes the
cache prefix ``k_all[:, :n]`` with no copy; MLA's prefill the value half
of its up-projection), and writes a new contiguous (B, T, H, Dv). A
sliding ``window`` w > 0 (causal self-attention, T == S) limits query row
i to keys i - w < j <= i, and the kernels skip the key tiles outside that
band.

Three kernels, chosen by T, dtype and (D, Dv) only (:func:`path_of`):
``"tile_tc"`` (T > 1, bfloat16, (D, Dv) one of ``TC_DIMS``: ``wgmma``
products fed by a TMA ring, the softmax weights rounded to bfloat16 for
the P.V product, as the plain version rounds them to v's dtype; its plain
twin is ``ref.flash_attention_tc_torch``), ``"tile_simt"`` (T > 1
otherwise: float32 products on the CUDA cores, weights kept in float32)
and ``"decode_split"`` (T = 1: the keys split over blocks, all query heads
of a KV head in one block, partial states merged in split order by a
second launch; its plain twin is ``ref.flash_decode_split_torch``).
:func:`flash_mla_decode_cuda` is MLA's absorbed decode, every head over
one latent cache, split and merged, by dtype and widths
(:func:`mla_path_of`): ``"mla_decode_tc"`` (bfloat16 with r 64, 128, 192,
256 or 512 and rd 32 or 64, :func:`mla_tc_widths`, minicpm3's 256 + 32 and
deepseek-v2's 512 + 64 among them: the heads as the rows of wgmma products
fed by TMA, the weights rounded to bfloat16 for P.ckv, one wave of blocks,
its own merge in base 2; at r 512 two warpgroups each hold half of O's
columns; plain twin ``ref.flash_mla_decode_tc_torch``) and ``"mla_decode"``
(float32, and bfloat16 at other widths: the CUDA cores, merged as the
split decode; plain twin ``ref.flash_mla_decode_torch``). Each call counts
once in ``flash_attention_cuda.launches`` and once under its path in
``flash_attention_cuda.launches_by_path``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, library, stream_of
from .ref import check_window, split_chunk

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# (D, Dv) pairs of the tensor-core tile kernel: the dense family's square
# heads, MLA's 96-wide keys over 64-wide values (minicpm3) and 192-wide
# keys over 128-wide values (deepseek-v2), and kimi-k2's 112 (padded to
# 128 on the chip by the tensor maps' zero fill)
TC_DIMS = ((64, 64), (128, 128), (96, 64), (112, 112), (192, 128))
_INT_MAX = 2 ** 31 - 1
PATHS = ("tile_tc", "tile_simt", "decode_split", "mla_decode",
         "mla_decode_tc")
# The latent decode kernels' widths: r at most MLA_MAX_R and rd at most
# MLA_MAX_RD, each a multiple of 8; a block of the CUDA-core kernel takes
# up to MLA_HEADS heads where r <= MLA_NARROW_R, else MLA_WIDE_HEADS (its
# shared memory holds the heads' q rows 576 wide); one of the tensor-core
# kernel up to MLA_TC_HEADS. The plain versions take any widths.
MLA_MAX_R, MLA_MAX_RD = 512, 64
MLA_NARROW_R = 256
MLA_HEADS, MLA_WIDE_HEADS = 40, 32
MLA_TC_HEADS = 64
# r of the tensor-core latent decode: 64-column panels, up to 4 in one
# warpgroup's registers, 8 split over two
MLA_TC_R = (64, 128, 192, 256, 512)
# The tensor-core latent decode's grid: one wave, a block an SM of the
# H100's 132; its merge keeps at most MLA_TC_MAX_SPLITS splits' weights.
MLA_TC_BLOCKS = 132
MLA_TC_MAX_SPLITS = 1024
# The split decode's grid: about two waves of the H100's 132 SMs, each
# split at least SPLIT_MIN_KEYS keys; a block takes up to DECODE_HEADS
# query heads of one KV head.
DECODE_BLOCKS = 2 * 132
SPLIT_MIN_KEYS = 128
DECODE_HEADS = 8


def geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             what: str = "flash_attention_cuda") -> tuple:
    """The kernel's shape and stride arguments for q (B, T, H, D), k (B, S,
    Hkv, D) and v (B, S, Hkv, Dv): (B, T, S, H, Hkv, D, Dv, q strides (b,
    t, h), k strides, v strides), in elements. Raises on what the kernel
    does not take."""
    if q.dtype not in _BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32/bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.ndim != 4 or k.ndim != 4 or v.ndim != 4
            or k.shape[:3] != v.shape[:3] or not 0 < v.shape[3] <= k.shape[3]):
        raise ValueError(f"{what}: bad shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, T, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
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
    return (B, T, S, H, Hkv, D, Dv, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3])


def path_of(q: torch.Tensor, dv: int | None = None) -> str:
    """The kernel a call with query q (B, T, H, D) and values ``dv`` wide
    (D when None) takes."""
    if q.shape[1] == 1:
        return "decode_split"
    d = q.shape[3]
    if q.dtype == torch.bfloat16 and (d, dv or d) in TC_DIMS:
        return "tile_tc"
    return "tile_simt"


def check_aligned(named, what: str) -> None:
    """Raise unless every (name, tensor) starts on a 16-byte boundary with
    every stride but the last a multiple of 16 bytes."""
    for name, t in named:
        esz = t.element_size()
        if t.data_ptr() % 16 or any(s * esz % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{what}: the tensor-core kernel needs {name} "
                             f"16-byte aligned with strides of 16-byte "
                             f"multiples, got {t.data_ptr() % 16} bytes off "
                             f"and strides {t.stride()}")


def check_tma(q, k, v, what: str = "flash_attention_cuda") -> None:
    """Raise unless q, k and v start on 16-byte boundaries and every
    stride is a multiple of 16 bytes, as the tensor-core tile kernel's TMA
    tensor maps need."""
    check_aligned((("q", q), ("k", k), ("v", v)), what)


def decode_splits(n: int, blocks: int) -> int:
    """Splits of a decode over ``n`` keys whose grid has ``blocks`` blocks
    per split: about ``DECODE_BLOCKS`` blocks in all, each split at least
    ``SPLIT_MIN_KEYS`` keys, at least one split."""
    return max(1, min(round(DECODE_BLOCKS / blocks), n // SPLIT_MIN_KEYS))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool,
                         window: int = 0, lse: bool = False):
    """Attention of q (B, T, H, D) over k (B, S, Hkv, D) and v (B, S, Hkv,
    Dv) on the card -> (B, T, H, Dv) in q's dtype, within a sliding
    ``window`` when it is positive. With ``lse`` (the split decode only)
    -> (out, lse), lse (B, H) float32 the log of each head's softmax
    denominator, written by the merge. Counts each call in ``.launches``
    and under its path in ``.launches_by_path``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda needs q, k, v on one "
                             f"CUDA device, got {name} on {t.device}")
    g = geometry(q, k, v)
    check_window(q.shape[1], k.shape[1], causal, window,
                 "flash_attention_cuda")
    path = path_of(q, v.shape[3])
    if lse and path != "decode_split":
        raise ValueError(f"flash_attention_cuda: lse is the split decode's "
                         f"output, not {path}'s")
    if path == "tile_tc":
        check_tma(q, k, v)
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    lib = library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if path == "decode_split":
            B, _, S, H, Hkv, D, Dv = g[:7]
            n = 1 if causal else S      # the one query sits at position 0
            n_split = decode_splits(n, B * Hkv * -(-(H // Hkv)
                                                  // DECODE_HEADS))
            ml = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                             device=q.device)
            acc = torch.empty((B, H, n_split, Dv), dtype=torch.float32,
                              device=q.device)
            lse_out = (torch.empty((B, H), dtype=torch.float32,
                                   device=q.device) if lse else None)
            err = lib.soar_flash_decode(
                *ptrs, _BF16[q.dtype], B, n, H, Hkv, D, Dv, q.stride(0),
                q.stride(2), *k.stride()[:3], *v.stride()[:3],
                out.stride(0), out.stride(2), float(scale), n_split,
                split_chunk(n, n_split), ml.data_ptr(), acc.data_ptr(),
                None if lse_out is None else lse_out.data_ptr(),
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
    return (out, lse_out) if lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_path = dict.fromkeys(PATHS, 0)


def mla_shapes(q_lat, q_rope, ckv, kr,
               what: str = "flash_mla_decode") -> tuple:
    """(B, n, H, r, rd) of the latent decode's q_lat (B, 1, H, r), q_rope
    (B, 1, H, rd), ckv (B, n, r) and kr (B, n, rd): what the plain
    version's arithmetic needs. Raises on inputs that do not fit
    together."""
    ts = (q_lat, q_rope, ckv, kr)
    if q_lat.dtype not in _BF16 or any(t.dtype != q_lat.dtype for t in ts):
        raise TypeError(f"{what} takes float32/bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if q_lat.ndim != 4 or q_rope.ndim != 4 or ckv.ndim != 3 or kr.ndim != 3:
        raise ValueError(f"{what}: bad shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    B, T, H, r = q_lat.shape
    n, rd = ckv.shape[1], kr.shape[2]
    if (T != 1 or q_rope.shape != (B, 1, H, rd) or ckv.shape != (B, n, r)
            or kr.shape[:2] != (B, n) or min(B, H, n, r, rd) < 1):
        raise ValueError(f"{what}: needs q_lat (B, 1, H, r), q_rope (B, 1, "
                         f"H, rd), ckv (B, n, r), kr (B, n, rd), got "
                         f"{[tuple(t.shape) for t in ts]}")
    return B, n, H, r, rd


def mla_geometry(q_lat, q_rope, ckv, kr,
                 what: str = "flash_mla_decode_cuda") -> tuple:
    """:func:`mla_shapes` and what the kernels take besides: r <= MLA_MAX_R
    and rd <= MLA_MAX_RD multiples of 8, contiguous last dimensions.
    Raises on what the kernels do not take."""
    ts = (q_lat, q_rope, ckv, kr)
    B, n, H, r, rd = mla_shapes(*ts, what)
    if r % 8 or rd % 8 or r > MLA_MAX_R or rd > MLA_MAX_RD:
        raise ValueError(f"{what}: needs r <= {MLA_MAX_R} and rd <= "
                         f"{MLA_MAX_RD} multiples of 8, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if max(n, B * H) > _INT_MAX:
        raise ValueError(f"{what}: too many positions for "
                         f"{[tuple(t.shape) for t in ts]}")
    for name, t in zip(("q_lat", "q_rope", "ckv", "kr"), ts):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    return B, n, H, r, rd


def mla_heads(r: int) -> int:
    """Heads a block of the CUDA-core latent decode takes at latent width
    ``r``."""
    return MLA_HEADS if r <= MLA_NARROW_R else MLA_WIDE_HEADS


def mla_splits(b: int, h: int, n: int, r: int = MLA_NARROW_R) -> int:
    """Splits of the CUDA-core latent decode over ``n`` keys for ``b``
    sequences of ``h`` heads at latent width ``r``: its grid has b x
    ceil(h / mla_heads(r)) blocks a split."""
    return decode_splits(n, b * -(-h // mla_heads(r)))


def mla_tc_splits(b: int, h: int, n: int) -> int:
    """Splits of the tensor-core latent decode over ``n`` keys for ``b``
    sequences of ``h`` heads: about ``MLA_TC_BLOCKS`` blocks in all (its
    grid has b x ceil(h / MLA_TC_HEADS) blocks a split), each split at
    least ``SPLIT_MIN_KEYS`` keys, at least one split and at most
    ``MLA_TC_MAX_SPLITS``."""
    blocks = b * -(-h // MLA_TC_HEADS)
    return max(1, min(round(MLA_TC_BLOCKS / blocks), n // SPLIT_MIN_KEYS,
                      MLA_TC_MAX_SPLITS))


def mla_tc_widths(r: int, rd: int) -> bool:
    """Whether the tensor-core latent decode takes a latent ``r`` and a
    rope width ``rd`` wide: r one of ``MLA_TC_R``, rd 32 or 64."""
    return r in MLA_TC_R and rd in (32, 64)


def mla_path_of(q_lat: torch.Tensor, q_rope: torch.Tensor) -> str:
    """The latent decode kernel a call with ``q_lat`` and ``q_rope`` takes:
    by dtype and widths."""
    tc = (q_lat.dtype == torch.bfloat16
          and mla_tc_widths(q_lat.shape[-1], q_rope.shape[-1]))
    return "mla_decode_tc" if tc else "mla_decode"


def mla_splits_of(q_lat: torch.Tensor, q_rope: torch.Tensor, n: int) -> int:
    """The splits the latent decode kernel of this call takes."""
    b, _, h, r = q_lat.shape
    if mla_path_of(q_lat, q_rope) == "mla_decode_tc":
        return mla_tc_splits(b, h, n)
    return mla_splits(b, h, n, r)


def kernel_info(kernel: str, x: int, y: int) -> dict:
    """What the compiler and the occupancy calculator give a kernel on this
    card: ``"tile_tc"`` at (D, Dv) = (x, y), or ``"mla_decode_tc"`` at (r,
    rd) = (x, y): registers a thread, spill (local) bytes a thread, blocks
    an SM and shared memory a block."""
    out = (ctypes.c_int * 4)()
    which = {"tile_tc": 0, "mla_decode_tc": 1}[kernel]
    check(library().soar_flash_kernel_info(which, x, y, ctypes.addressof(out)),
          f"kernel info ({kernel} at {x}, {y})")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm",
                     "smem_bytes"), out))


def flash_mla_decode_cuda(q_lat: torch.Tensor, q_rope: torch.Tensor,
                          ckv: torch.Tensor, kr: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """MLA's absorbed decode on the card: q_lat (B, 1, H, r) and q_rope
    (B, 1, H, rd) over the latent cache ckv (B, n, r), kr (B, n, rd) (views
    of the cache prefix) -> ctx_lat (B, 1, H, r) in q_lat's dtype: softmax
    over the n keys of (q_lat . ckv + q_rope . kr) * scale, then the
    weights times ckv. bfloat16 at the widths :func:`mla_tc_widths` takes
    runs the tensor-core kernel (inputs 16-byte aligned with strides of
    16-byte multiples, else it raises), everything else the CUDA-core one.
    Counts in ``flash_attention_cuda.launches`` and under its path."""
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("ckv", ckv),
                    ("kr", kr)):
        if t.device.type != "cuda" or t.device != q_lat.device:
            raise ValueError(f"flash_mla_decode_cuda needs its inputs on one "
                             f"CUDA device, got {name} on {t.device}")
    B, n, H, r, rd = mla_geometry(q_lat, q_rope, ckv, kr)
    path = mla_path_of(q_lat, q_rope)
    if path == "mla_decode_tc":
        check_aligned((("q_lat", q_lat), ("q_rope", q_rope), ("ckv", ckv),
                       ("kr", kr)), "flash_mla_decode_cuda")
    n_split = mla_splits_of(q_lat, q_rope, n)
    dev = q_lat.device
    out = torch.empty((B, 1, H, r), dtype=q_lat.dtype, device=dev)
    ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=dev)
    acc = torch.empty((B, H, n_split, r), dtype=torch.float32, device=dev)
    lib = library()
    ptrs = (q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
            kr.data_ptr(), out.data_ptr())
    rest = (B, n, H, r, rd, q_lat.stride(0), q_lat.stride(2),
            q_rope.stride(0), q_rope.stride(2), ckv.stride(0), ckv.stride(1),
            kr.stride(0), kr.stride(1), float(scale), n_split,
            split_chunk(n, n_split), ml.data_ptr(), acc.data_ptr(),
            stream_of(q_lat))
    with torch.cuda.device(dev):
        if path == "mla_decode_tc":
            err = lib.soar_flash_mla_decode_tc(*ptrs, *rest)
        else:
            err = lib.soar_flash_mla_decode(*ptrs, _BF16[q_lat.dtype], *rest)
    check(err, f"flash attention launch ({path})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_path[path] += 1
    return out
