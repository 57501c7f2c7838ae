"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources in ``src/repro_torch/csrc`` compile on first use into
``build/kernels/libsoar_torch-<hash>.so`` at the repository root, one
``nvcc`` per source started together, then one link. The hash covers the
sources and the flags, so an edited kernel rebuilds and an unchanged one
loads from disk. The library has a plain C interface: every entry takes
device pointers and a stream as ``void*`` and returns the launch's
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here falls back: without ``nvcc`` or with a failing build the
caller gets a ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, R0, scratch, table, mask, out, out_rows, G, C, D, tile, vec, stream
_SEGMENT_REDUCE = (_P, ctypes.c_longlong) + (_P,) * 5 + (
    _I, _I, ctypes.c_longlong, _I, _I, _P)
_SIGNATURES = {
    "soar_minplus_f32": (_P, _P, _P, ctypes.c_longlong, _I, _P),
    "soar_minplus_f64": (_P, _P, _P, ctypes.c_longlong, _I, _P),
    "soar_color_level_f32": (_P,) * 11 + (_I,) * 8 + (_P,),
    "soar_color_level_f64": (_P,) * 11 + (_I,) * 8 + (_P,),
    "soar_levelfold_f32": (_P,) * 8 + (_I,) * 6 + (_P,),
    "soar_levelfold_f64": (_P,) * 8 + (_I,) * 6 + (_P,),
    "soar_segment_reduce_f32": _SEGMENT_REDUCE,
    "soar_segment_reduce_bf16": _SEGMENT_REDUCE,
    "soar_segment_reduce_bf16_round_each": _SEGMENT_REDUCE,
    "soar_topk_scratch": (_I, _I, ctypes.c_longlong, _I, _I, _P),
    "soar_topk_select": (_P, _I, _I, ctypes.c_longlong, _I, _P, _P, _P, _P),
    "soar_topk_compress": (_P, _I, _I, ctypes.c_longlong, _I) + (_P,) * 5,
    "soar_flash_tile": (_P,) * 4 + (_I,) * 8 + (ctypes.c_longlong,) * 12
    + (_I, _I, ctypes.c_float, _P),
    "soar_flash_tile_tc": (_P,) * 4 + (_I,) * 7 + (ctypes.c_longlong,) * 12
    + (_I, _I, ctypes.c_float, _P),
    "soar_flash_decode": (_P,) * 4 + (_I,) * 7 + (ctypes.c_longlong,) * 10
    + (ctypes.c_float, _I, _I, _P, _P, _P, _P),
    "soar_flash_mla_decode": (_P,) * 5 + (_I,) * 6
    + (ctypes.c_longlong,) * 8 + (ctypes.c_float, _I, _I, _P, _P, _P),
    "soar_flash_mla_decode_tc": (_P,) * 5 + (_I,) * 5
    + (ctypes.c_longlong,) * 8 + (ctypes.c_float, _I, _I, _P, _P, _P),
    "soar_flash_kernel_info": (_I, _I, _I, _P),
    "soar_ssm_scan": (_P,) * 9 + (_I,) * 4 + (ctypes.c_longlong,) * 8
    + (_P,),
    "soar_ssm_scan_bwd_plan": (_I,) * 4 + (_P,),
    "soar_ssm_scan_bwd": (_P,) * 15 + (_I,) * 4 + (ctypes.c_longlong,) * 8
    + (_P,),
    "soar_ex2_sweep": (ctypes.c_uint, ctypes.c_ulonglong, _P, _P),
}

_lib: ctypes.CDLL | None = None
#: Seconds the first :func:`library` call took (compile + link + load),
#: None before it.
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build from src/repro_torch/csrc "
        "on first use and need the CUDA toolkit (set CUDA_HOME)")


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with every failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    try:
        outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [f"$ {' '.join(c)}\n{o}" for c, p, o in zip(cmds, procs, outs)
            if p.returncode != 0]
    if errs:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errs))


def _compile(sources: list[Path], so: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                  for p, o in zip(sources, objs)])
        staged = str(Path(tmp) / so.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", staged]])
        os.replace(staged, so)      # atomic: concurrent builds agree


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libsoar_torch-{_digest(sources + sorted(CSRC.glob('*.cuh')))}.so"
    if not so.exists():
        _compile(sources, so)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.soar_ssm_scan_bwd_scratch.argtypes = [_I] * 4
    lib.soar_ssm_scan_bwd_scratch.restype = ctypes.c_longlong
    lib.soar_cuda_error_string.argtypes = [ctypes.c_int]
    lib.soar_cuda_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def built_kernels() -> tuple[str, ...]:
    """Entry points of the loaded library (empty before the first build)."""
    return tuple(_SIGNATURES) if _lib is not None else ()


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err:
        msg = library().soar_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of tensor ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
