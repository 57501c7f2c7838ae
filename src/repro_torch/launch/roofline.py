"""Roofline terms of a step, counted from the aten operators one rank
dispatches: the port of the JAX package's ``launch/roofline.py``.

JAX reads its counts off the compiled, SPMD-partitioned HLO. Eager
PyTorch has no HLO: :class:`StepCounter`, a ``TorchDispatchMode``, sees
every aten operator one rank's step dispatches, after autograd and the
composite operators (``einsum``, ``matmul``, ``linear``) have been
decomposed and after DTensor has reduced its operators to this rank's
local ones (under ``inference_mode`` a composite arrives whole, and the
counter decomposes it). It counts by JAX's rules, per device:

  * FLOPs = sum over the dot-class operators (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot``; ``einsum`` and
    ``matmul`` decompose into them) of 2 * numel(out) * contracted size;
  * collective bytes = the operand bytes of each c10d or functional
    collective, by JAX's kinds: all-gather, reduce-scatter, all-to-all,
    all-reduce, and collective-permute for a point-to-point send (the
    rank executor's broadcast and gather keep their own names). Every
    exchange of ``collectives.axis_ops`` reaches c10d; its
    ``exchange_log`` names the axis of each;
  * memory bytes = operand + output bytes of every operator that launches
    work. Views and metadata operators (``view``, ``_unsafe_view``,
    ``expand``, ``t``, ``transpose``, ``slice``, ``as_strided``,
    ``detach``, ``alias``: every ``OpOverload.is_view``), allocations
    without a fill (``empty*``) and the ``prim`` namespace are skipped,
    as ``_SKIP_MEM`` skips ``bitcast`` and ``tuple``. Two operators read
    less than their operands: ``embedding`` reads the rows it gathers, and
    ``copy_``, ``fill_`` and ``zero_`` do not read their destination.

How the counts differ from JAX's:

  * Eager mode has no fusion. Each elementwise operator reads its
    operands and writes its output, where XLA's fusion keeps the
    intermediate values on chip, so this memory proxy is larger than
    JAX's fusion-aware count; the FLOPs and collective bytes are not
    changed by it.
  * The port's CUDA kernels are ``ctypes`` calls on raw pointers
    (``kernels/_build.py``), which no dispatch mode sees. The counter
    therefore counts the step on CPU tensors (fake ones at full size),
    where each kernel's plain version runs, and counts each plain version
    as its kernel (``kernels.plain.kernel_call``): one row
    ``kernel.<name>`` with its operands read once and its outputs written
    once (the kernel keeps a prefill's (T, S) scores or a scan's states
    on chip) and the plain version's dot FLOPs. Those FLOPs are the plain
    path's: training attention runs ``sdpa`` or, from 2,048 tokens,
    ``sdpa_blocked`` (plain torch on the card too), which skips the key
    tiles past the diagonal (and outside a window) as JAX's jnp path
    does; the flash kernel's plain version computes a causal prefill's
    whole (T, S) square and masks it, where JAX's jnp prefill takes
    ``sdpa_blocked`` from 2,048 tokens and skips the tiles above the
    diagonal (and the card's tensor-core tile its masked tiles); its
    windowed prefill computes row blocks of max(window, ``WINDOW_ROWS``)
    over the keys they can see.
  * ``parse_computations``, ``computation_multipliers``, ``_trip_count``
    and ``_fusion_slice_bytes`` (JAX's :67-256) have no twin. There is no
    HLO text to parse. Eager dispatch runs every layer of a stacked model
    (a Python loop, no ``while`` body), so there is no loop body whose
    counts need a trip count. A slice is a view the counter skips, and
    the operator that reads it counts the slice only, which is what
    ``_fusion_slice_bytes`` reckons for a fusion's ``dynamic-slice``.

Hardware constants: one NVIDIA H100 SXM at its 700 W power limit, the
data sheet's dense rates: 989 TFLOP/s bfloat16 on the tensor cores, 67
TFLOP/s float32 outside them (the peak of a float32 step with TF32 off),
3.35 TB/s and 80 GB of HBM, NVLink's 900 GB/s counted one direction
(450 GB/s). A mesh wider than one node of 8 cards also crosses the
network, whose rate is not known here, so ``collective_s`` is a floor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12       # bfloat16, tensor cores, dense
FP32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BW = 3.35e12          # bytes/s
HBM_BYTES = 80e9          # device memory
LINK_BW = 450e9           # NVLink 4, 900 GB/s both directions, one way

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# dot-class operators: the index of the operand whose last dimension is
# contracted
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "mv": 0, "addmv": 1,
         "dot": 0, "vdot": 0}

# the c10d collectives the port's ``Link`` dispatches, and the functional
# ones a DTensor redistribution does (``parallel.sharding.cs``): kind,
# operand argument, output argument (None: the operand, written in place;
# "ret": the returned tensor; "none": nothing written here)
_COLL = {
    "allgather_": ("all-gather", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "broadcast_": ("broadcast", 0, None),
    "gather_": ("gather", 1, 0),
    "send": ("collective-permute", 0, "none"),
    "all_gather_into_tensor": ("all-gather", 0, "ret"),
    "all_reduce": ("all-reduce", 0, "ret"),
    "reduce_scatter_tensor": ("reduce-scatter", 0, "ret"),
    "all_to_all_single": ("all-to-all", 0, "ret"),
}
_NO_DATA = {"wait_tensor", "barrier", "monitored_barrier_"}
_NO_READ = {"copy_", "fill_", "zero_"}    # the destination is not read
_NO_WORK = {"_unsafe_view", "empty", "empty_like", "empty_strided",
            "new_empty", "new_empty_strided", "resize_", "set_"}

_PKG = pathlib.Path(__file__).resolve().parents[1]
# frames of the collective plumbing and the kernel wrappers: a row names
# their caller instead
_PLUMBING = {str(_PKG / "collectives" / "axis_ops.py"),
             str(_PKG / "collectives" / "tree_allreduce.py"), __file__,
             str(_PKG / "kernels" / "plain.py"),
             *map(str, (_PKG / "kernels").glob("*/ops.py"))}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
           torch.float64: "f64", torch.int64: "s64", torch.int32: "s32",
           torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
           torch.bool: "pred"}


@dataclasses.dataclass
class StepStats:
    """The twin of JAX's ``HloStats``, per device."""
    flops: float = 0.0                 # dot-class operators
    memory_bytes: float = 0.0          # HBM-traffic proxy (no fusion)
    collective_bytes: float = 0.0      # sum of operand bytes
    collective_ops: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OpRecord:
    """One dispatched operator: its aten name, its tensors' shapes
    (operands -> outputs, HLO-style), where in the port it ran (the
    innermost ``repro_torch`` frame outside the collective plumbing; in a
    backward pass also the autograd node), its dot FLOPs and the dtype of
    its operands, its memory bytes (0: a view or metadata operator) and,
    for a collective, its kind and operand bytes."""
    op: str
    shapes: str
    path: str
    flops: float = 0.0
    dtype: str = ""
    bytes: int = 0
    collective: str | None = None
    collective_bytes: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _shape(t: torch.Tensor) -> str:
    return (f"{_DTYPES.get(t.dtype, str(t.dtype)[6:])}"
            f"[{','.join(map(str, t.shape))}]")


_REL: dict = {}     # a frame's file -> its path in the package, or None


def _rel(name: str) -> str | None:
    if name not in _REL:
        inside = name.startswith(str(_PKG)) and name not in _PLUMBING
        _REL[name] = (pathlib.Path(name).relative_to(_PKG).as_posix()
                      if inside else None)
    return _REL[name]


def _where() -> str:
    f = sys._getframe(2)
    while f is not None:
        rel = _rel(f.f_code.co_filename)
        if rel is not None:
            path = f"{rel}:{f.f_code.co_name}"
            break
        f = f.f_back
    else:
        path = "?"
    node = torch._C._current_autograd_node()
    return path if node is None else f"{path} [{node.name()}]"


def _dot_flops(name: str, args, out) -> float:
    lhs = args[_DOTS[name]]
    k = lhs.numel() if name in ("dot", "vdot") else lhs.shape[-1]
    return 2.0 * out.numel() * k


class StepCounter(TorchDispatchMode):
    """Records every operator dispatched while it is active
    (``records``, a list of :class:`OpRecord`); ``stats()`` sums them into
    a :class:`StepStats`. DTensor operators are left to DTensor, whose
    local operators the counter then sees, so a rank's counts are its own
    shards'."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        #: a context manager factory entered around each kernel call
        self.around_kernel = contextlib.nullcontext

    @contextlib.contextmanager
    def kernel_call(self, name: str, operands):
        """One row ``kernel.<name>`` for the operators a kernel's plain
        version dispatches inside the ``with`` block (``kernels.plain``):
        their dot FLOPs (or those given to the yielded ``done``), and the
        bytes the kernel moves, ``operands`` read once and the outputs
        given to ``done`` written once."""
        start, outs, given = len(self.records), [], []

        def done(out, flops=None):
            outs.append(out)
            given.extend([] if flops is None else [flops])
            return out

        with self.around_kernel():
            yield done
        inner = self.records[start:]
        del self.records[start:]
        ins, made = _tensors(operands), _tensors(outs)
        dots = [r for r in inner if r.flops]
        self.records.append(OpRecord(
            f"kernel.{name}", ", ".join(map(_shape, ins)) + " -> "
            + ", ".join(map(_shape, made)), _where(),
            flops=given[0] if given else sum(r.flops for r in dots),
            dtype=dots[0].dtype if dots else _DTYPES.get(ins[0].dtype, ""),
            bytes=sum(map(_nbytes, ins)) + sum(map(_nbytes, made))))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is not torch.ops.prim.device.default:
            with self:      # under inference_mode composites arrive whole
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        if ns == "prim" or name in _NO_DATA:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        rec = OpRecord(f"{ns}.{name}", ", ".join(map(_shape, ins)) + " -> "
                       + ", ".join(map(_shape, outs)), _where())
        if func.is_view or name in _NO_WORK:
            self.records.append(rec)
            return out
        if name in _DOTS:
            rec.flops = _dot_flops(name, args, outs[0])
            rec.dtype = _DTYPES.get(ins[0].dtype, str(ins[0].dtype))
        if name in _COLL:
            kind, src, dst = _COLL[name]
            operand = sum(map(_nbytes, _tensors(args[src])))
            written = (operand if dst is None else 0 if dst == "none"
                       else sum(map(_nbytes, outs)) if dst == "ret"
                       else sum(map(_nbytes, _tensors(args[dst]))))
            rec.collective, rec.collective_bytes = kind, operand
            rec.bytes = operand + written
        elif name == "recv_":               # the sender counts the message
            rec.bytes = sum(map(_nbytes, _tensors(args[0])))
        else:
            if name == "embedding":         # the rows gathered, not the table
                w, idx = args[0], args[1]
                read = idx.numel() * w.shape[-1] * w.element_size() + _nbytes(
                    idx)
            else:
                read = sum(map(_nbytes, ins[1:] if name in _NO_READ
                               else ins))
            rec.bytes = read + sum(map(_nbytes, outs))
        self.records.append(rec)
        return out

    def stats(self) -> StepStats:
        s = StepStats()
        for r in self.records:
            s.flops += r.flops
            s.memory_bytes += r.bytes
            if r.collective:
                s.collective_bytes += r.collective_bytes
                s.collective_ops[r.collective] = s.collective_ops.get(
                    r.collective, 0) + 1
        return s


def flops_by_dtype(records) -> dict:
    """Dot FLOPs by the dtype of their operands: the peak a step's
    compute term takes is its matmuls' (bfloat16 ``PEAK_FLOPS``, float32
    ``FP32_FLOPS`` with TF32 off)."""
    out: dict = {}
    for r in records:
        if r.flops:
            out[r.dtype] = out.get(r.dtype, 0.0) + r.flops
    return out


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

def roofline_terms(stats: StepStats, n_devices: int,
                   peak_flops: float | None = None) -> dict:
    """Seconds per step for each roof, from per-device stats; the compute
    roof at ``peak_flops`` (default ``PEAK_FLOPS``, bfloat16)."""
    compute_s = stats.flops / (peak_flops or PEAK_FLOPS)
    memory_s = stats.memory_bytes / HBM_BW
    collective_s = stats.collective_bytes / LINK_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "flops_per_device": stats.flops,
        "flops_global": stats.flops * n_devices,
        "memory_bytes_per_device": stats.memory_bytes,
        "collective_bytes_per_device": stats.collective_bytes,
        "collective_ops": stats.collective_ops,
    }
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda kv: kv[1])
    terms["bottleneck"] = dom[0]
    terms["step_time_lower_bound_s"] = dom[1]
    return terms


def model_flops(cfg, shape, mode: str) -> float:
    """MODEL_FLOPS: 6*N*D for train (3x fwd+bwd), 2*N*D forward-only.

    N = active params, D = tokens processed.
    """
    n = cfg.active_param_count()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
