"""A sharded step's parameters gathered one layer at a time, tensor
parallelism over ``model``, the vocabulary split over ``model``, and the
decode's combine of the ``model`` ranks' blocks of positions: what GSPMD
does inside the JAX package's partitioned steps (``jit(...,
in_shardings=named(mesh, param_pspecs))``), where the layer scan gathers
each layer's shards and the products named ``heads``, ``ff`` and
``vocab`` split over ``model``.

``launch.sharded`` installs a :class:`Plan` for one step
(:func:`installed`); the model code calls the hooks below at every layer,
at the embedding and at the head. With no plan installed every hook is
the identity (or ``None``), so one process's model runs as before, bit
for bit.

A leaf's *role* says how its shard becomes what the layer computes with,
and how the gradient of that becomes the gradient of the shard:

  whole    all-gathered over every mesh axis that shards it; the layer
           computes with it alike on every ``model`` rank, so the gradient
           is this rank's slice over ``model`` (``take_own``, not a sum:
           the ``model`` ranks hold equal copies) and the sum over the dp
           ranks (``reduce_to_shard``: each peer's shard, summed in
           dp-rank order in float32)
  tp       gathered over the dp axes only; the layer computes with its
           ``model`` shard (column-parallel ``w_q``, ``w_k``, ``w_v``,
           ``w_gate``, ``w_up``; row-parallel ``w_o``, ``w_down``; the
           embedding's rows and the head's columns), so the gradient is
           summed over dp only
  kv       ``w_k``/``w_v`` where ``model`` does not divide the KV heads:
           gathered over every axis, then the columns of the one KV head
           this rank's query heads read; the ``model`` ranks' gradients
           are parts, summed over dp and ``model``
  partial  ``q_norm``/``k_norm`` beside tensor-parallel heads: replicated,
           each rank's gradient from its own heads, summed over dp and
           ``model``
  keep     the MoE leaves the expert-parallel lowerings take as this
           rank's shards, untouched (their collectives' transposes give
           the gradient)

The gather is one ``torch.autograd.Function`` (:class:`_Gather`) a leaf;
its backward is the reduction above, so a layer's gradient is
reduce-scattered as the backward produces it and no whole gradient
outlives its layer. The model calls :func:`layer` inside the layer's body,
under ``torch.utils.checkpoint`` where ``cfg.remat``: the recompute
gathers again, and no whole layer lives from the forward to the backward.

Tensor parallelism (training, the GQA attention where ``model`` divides
the heads; the dense MLP, training and serving): :func:`tp_in` before the
column-parallel products (the identity; its backward sums the input's
gradient over ``model``) and :func:`tp_out` after the row-parallel one
(the sum over ``model`` in rank order, in float32; its backward the
identity). Serving's attention runs every head on every ``model`` rank,
over its block of the cache's positions (:func:`decode_block`), and the
ranks merge their outputs by log-sum-exp (:func:`combine`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import weakref

import torch
from torch.distributed.tensor import Replicate

from ..collectives import axis_ops as ops

_STATE = threading.local()

#: the MoE leaves the EP lowerings take as this rank's shards
EP_LEAVES = re.compile(r".*(router/w|experts/w_(gate|up|down))$")
#: subtrees whose leaves stack the layers on a leading axis
STACKED = ("layers", "enc_layers", "dec_layers")
_LAYER = r"(layers|prefix/\d+|blocks/\d+)"
#: a GQA layer's leaves that tensor parallelism splits (or sums) over model
ATTN_LEAVES = re.compile(_LAYER
                         + r"/attn/(w_q|w_k|w_v|w_o|q_norm|k_norm)")
#: a dense MLP's leaves, split over model
MLP_LEAVES = re.compile(_LAYER + r"/mlp/(w_gate|w_up|w_down)")


def local_slice(t: torch.Tensor, mesh, pls, coord) -> torch.Tensor:
    """The block of ``t`` that placements ``pls`` put at mesh coordinate
    ``coord``: DTensor splits a dimension mesh dimension by mesh dimension,
    the first the major one (its sizes must divide)."""
    for size, pl, c in zip(mesh.mesh.shape, pls, coord):
        if pl.is_shard():
            if t.shape[pl.dim] % size:
                raise ValueError(f"dimension {pl.dim} of {tuple(t.shape)} "
                                 f"does not split over {size} ranks")
            t = t.chunk(size, pl.dim)[c]
    return t


def reduce_to_shard(g, mesh, pls, coord, dims, ax):
    """This rank's shard of the sum over the ranks of mesh dimensions
    ``dims`` (the group ``ax``) of their ``g``: each rank sends every peer
    that peer's shard of its ``g`` (one all-to-all), then sums what it
    receives in group-rank order, accumulated in float32."""
    if ax.size == 1:
        return local_slice(g, mesh, pls, coord).contiguous()
    parts = []
    for j in range(ax.size):
        c, rest = list(coord), j
        for i in reversed(dims):
            c[i], rest = rest % mesh.mesh.shape[i], rest // mesh.mesh.shape[i]
        parts.append(local_slice(g, mesh, pls, c))
    with torch.no_grad():
        got = ops.all_to_all(torch.stack(parts), ax)
    return ops.ordered_sum(list(got), g.dtype)


def take_own(g, mesh, pls, coord, dims, ax):
    """The gradient of a leaf the ``model`` ranks (mesh dimensions
    ``dims``, the group ``ax``) computed with alike: every rank holds the
    same whole gradient, and its shard is its own slice (a sum over the
    copies would be ``ax.size`` times the gradient)."""
    return local_slice(g, mesh, pls, coord)


# -- the plan -----------------------------------------------------------------

def _release(live: dict, n: int) -> None:
    live["now"] -= n


@dataclasses.dataclass(eq=False)
class _Spec:
    """One leaf's gather: the layer-local placements, the mesh dimensions
    gathered, those whose gradient is this rank's slice, those it is
    summed over, and the columns kept (``kv``)."""
    plan: "Plan"
    pls: tuple
    gather_dims: tuple
    own_dims: tuple
    sum_dims: tuple
    cols: tuple | None = None
    whole: tuple | None = None        # the kv leaf's gathered shape

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        plan = self.plan
        with torch.no_grad():
            for i in reversed(self.gather_dims):
                x = ops.all_gather(x, plan.axes[(i,)], self.pls[i].dim)
            if self.cols is not None:
                self.whole = tuple(x.shape)
                x = x[..., self.cols[0]:self.cols[1]].clone()
        return x

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        plan = self.plan
        if self.cols is not None:
            whole = g.new_zeros(self.whole)
            whole[..., self.cols[0]:self.cols[1]] = g
            g = whole
        if self.own_dims:
            g = take_own(g, plan.mesh, self._only(self.own_dims), plan.coord,
                         self.own_dims, plan.axes[self.own_dims])
        return reduce_to_shard(g, plan.mesh, self._only(
            tuple(i for i in self.sum_dims if i in self.gather_dims)),
            plan.coord, self.sum_dims, plan.axes[self.sum_dims])

    def _only(self, dims) -> tuple:
        return tuple(pl if i in dims else Replicate()
                     for i, pl in enumerate(self.pls))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        out = spec.gather(x)
        if out is x:
            return x.view_as(x)
        spec.plan.track(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return ctx.spec.reduce(g.contiguous()), None


def _local_placements(path: str, pls) -> tuple:
    """A stacked leaf's placements for one layer's slice (its layer axis,
    never sharded, dropped)."""
    if path.split("/")[0] not in STACKED:
        return tuple(pls)
    out = []
    for pl in pls:
        if pl.is_shard():
            if pl.dim == 0:
                raise ValueError(f"{path}: the layer axis is sharded")
            pl = type(pl)(pl.dim - 1)
        out.append(pl)
    return tuple(out)


class Plan:
    """How one step of ``cfg`` on ``mesh`` uses the parameters placed as
    ``placements`` (path -> DTensor placements): each leaf's role, the
    groups it gathers and sums over, the tensor-parallel switches, the
    vocabulary's split and, for a decode, the caches whose positions the
    ``model`` ranks hold in blocks (``blocks``: a block's length -> the
    cache's, set by ``launch.sharded.ShardedServeStep``); ``gathered``
    counts the bytes of gathered parameters alive (``now``) and the most
    alive at once (``peak``). Every rank of the mesh builds it alike
    (building it makes the groups, which is collective)."""

    def __init__(self, cfg, mesh, placements: dict, *, train: bool,
                 ep: str | None = None):
        self.cfg, self.mesh = cfg, mesh
        self.coord = tuple(mesh.get_coordinate())
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.mesh.shape))
        self.dp_dims = tuple(names.index(a) for a in ("pod", "data")
                             if a in names)
        self.model_dim = names.index("model") if "model" in names else None
        m = sizes.get("model", 1)
        self.m = m
        md = () if self.model_dim is None else (self.model_dim,)
        self.axes = {(i,): ops.axis(mesh, names[i]) for i in range(len(names))}
        for dims in (self.dp_dims, md, tuple(sorted(self.dp_dims + md))):
            self.axes[dims] = ops.axis(mesh, tuple(names[i] for i in dims))
        self.model = self.axes[md]
        self.ep, self.train = ep, train
        self.dp = self.axes[self.dp_dims]
        enc = cfg.is_encoder_decoder
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.tp_mlp = m > 1 and not enc and cfg.d_ff % m == 0
        h_loc = H // m
        self.kv_split = Hkv % m == 0
        self.tp_attn = (train and m > 1 and not enc and cfg.attn_type != "mla"
                        and H % m == 0 and (self.kv_split
                                            or (H // Hkv) % h_loc == 0))
        self.vocab = m > 1 and not enc and cfg.padded_vocab % m == 0
        self.v_local = cfg.padded_vocab // m
        r = self.model.rank
        self.v_offset = r * self.v_local
        self.kv_head = (r * h_loc) // (H // Hkv) if self.tp_attn else None
        self.blocks: dict = {}
        self.placements = placements
        self.specs: dict = {}
        self.seen: set = set()
        self.gathered = {"now": 0, "peak": 0}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``, a gather's output, in ``gathered``: the bytes of
        gathered parameters alive now and the most alive at once."""
        n = t.numel() * t.element_size()
        live = self.gathered
        live["now"] += n
        live["peak"] = max(live["peak"], live["now"])
        weakref.finalize(t, _release, live, n)

    def role(self, path: str) -> str:
        if self.ep is not None and EP_LEAVES.fullmatch(path):
            return "keep"
        if self.vocab and path in ("embed_tokens", "lm_head"):
            return "tp"
        if self.tp_mlp and MLP_LEAVES.fullmatch(path):
            return "tp"
        hit = ATTN_LEAVES.fullmatch(path) if self.tp_attn else None
        if hit:
            name = hit.group(2)
            if name in ("q_norm", "k_norm"):
                return "partial"
            if name in ("w_k", "w_v") and not self.kv_split:
                return "kv"
            return "tp"
        return "whole"

    def spec(self, path: str) -> _Spec | None:
        if path in self.specs:
            return self.specs[path]
        role = self.role(path)
        pls = _local_placements(path, self.placements[path])
        sharding = tuple(i for i, pl in enumerate(pls) if pl.is_shard())
        md = () if self.model_dim is None else (self.model_dim,)
        if role == "tp" and not set(md) <= set(sharding):
            raise ValueError(f"{path}: a tensor-parallel leaf not sharded "
                             f"over model ({pls})")
        gather = sharding if role != "tp" else tuple(
            i for i in sharding if i in self.dp_dims)
        if role == "whole":
            own = tuple(i for i in gather if i in md)
            total = self.dp_dims
        else:
            own = ()
            total = (self.dp_dims if role == "tp"
                     else tuple(sorted(self.dp_dims + md)))
        cols = None
        if role == "kv":
            hd = self.cfg.hd
            cols = (self.kv_head * hd, (self.kv_head + 1) * hd)
        spec = None
        if role != "keep" and (gather or own or cols
                               or self.axes[total].size > 1):
            spec = _Spec(self, pls, gather, own, total, cols)
        self.specs[path] = spec
        return spec


# -- the installed plan -------------------------------------------------------

@contextlib.contextmanager
def installed(plan: Plan | None):
    """``plan`` for this thread for the ``with`` block (the previous one
    back on exit)."""
    prev = getattr(_STATE, "plan", None)
    _STATE.plan = plan
    try:
        yield plan
    finally:
        _STATE.plan = prev


def current() -> Plan | None:
    return getattr(_STATE, "plan", None)


# -- the hooks ----------------------------------------------------------------

def _walk(tree, path: str, plan: Plan):
    if isinstance(tree, dict):
        return {k: _walk(v, f"{path}/{k}", plan) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, f"{path}/{i}", plan)
                          for i, v in enumerate(tree))
    plan.seen.add(path)
    spec = plan.spec(path)
    return tree if spec is None else _Gather.apply(tree, spec)


def layer(tree, path: str):
    """A layer's parameters (a subtree of this rank's shards, or one leaf;
    ``path`` its place in the parameter tree: ``layers`` for a stacked
    layer's slice, ``blocks/3``, ``final_norm``, ``embed_tokens``), each
    leaf gathered by its role; the tree itself without a plan."""
    plan = current()
    return tree if plan is None else _walk(tree, path, plan)


def tp(kind: str) -> bool:
    """Whether the installed plan splits ``kind`` (``"attn"``, ``"mlp"``)
    over ``model``."""
    plan = current()
    return plan is not None and getattr(plan, f"tp_{kind}")


def tp_in(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Ahead of a tensor-parallel ``kind``: the identity, whose backward
    sums the gradient over ``model`` (Megatron's f)."""
    return ops.varying(x, current().model) if tp(kind) else x


def tp_out(y: torch.Tensor, kind: str) -> torch.Tensor:
    """After a tensor-parallel ``kind``'s row-parallel product: the sum
    over ``model`` (Megatron's g; its backward the identity)."""
    return ops.psum(y, current().model) if tp(kind) else y


def vocab():
    """(``model`` group, first row, rows) of this rank's block of the
    vocabulary when the installed plan splits it, else None."""
    plan = current()
    if plan is None or not plan.vocab:
        return None
    return plan.model, plan.v_offset, plan.v_local


def _rows_travel(plan: Plan, n_tokens: int) -> bool:
    """Whether a serving step's embedding and head move the tokens'
    activations over the dp axes instead of gathering the vocabulary's
    table: when the dp ranks' tokens together are at most d_model (a
    decode step, a short prompt), fewer bytes than the table's dp shards.
    Training always gathers (its backward is the gather's)."""
    return (not plan.train and plan.dp.size > 1
            and n_tokens * plan.dp.size <= plan.cfg.d_model)


def _lookup(table, tokens, lo: int, n: int):
    idx = tokens - lo
    mine = (idx >= 0) & (idx < n)
    x = torch.nn.functional.embedding(idx.clamp(0, n - 1), table)
    return torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def embed(shard: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup of ``tokens`` in this rank's shard of
    ``embed_tokens`` (its rows of the vocabulary, its dp block of d): the
    rows of its block, zeros for the others, summed over ``model``
    (exactly one term is not zero). The table's dp blocks are gathered
    first; or, where the tokens' rows travel (``_rows_travel``), every dp
    rank's tokens are gathered, looked up in this rank's block of d, and
    one all-to-all over dp hands each rank its rows' blocks."""
    plan = current()
    ax, lo, n = vocab()
    if not _rows_travel(plan, tokens.numel()):
        return ops.psum(_lookup(layer(shard, "embed_tokens"), tokens, lo, n),
                        ax)
    plan.seen.add("embed_tokens")
    g = plan.dp.size
    rows = _lookup(shard, ops.all_gather(tokens.contiguous(), plan.dp, 0),
                   lo, n)
    got = ops.all_to_all(torch.stack(rows.chunk(g, 0)), plan.dp)
    return ops.psum(torch.cat(list(got), dim=-1), ax)


def head(x: torch.Tensor, shard: torch.Tensor, tied: bool) -> torch.Tensor:
    """The vocab-parallel logits of ``x`` (this rank's rows, normed):
    x times this rank's columns of the head (``lm_head``, or
    ``embed_tokens`` transposed where ``tied``). The head's dp blocks of d
    are gathered first; or, where the tokens' rows travel, every dp
    rank's x is gathered, multiplied by this rank's block of d in float32,
    and one all-to-all over dp hands each rank its rows' partial products,
    summed in dp-rank order in float32 and rounded once."""
    plan = current()
    path = "embed_tokens" if tied else "lm_head"
    if not _rows_travel(plan, x.shape[0] * x.shape[1]):
        w = layer(shard, path)
        return ops.varying(x, plan.model) @ (w.T if tied else w)
    plan.seen.add(path)
    g, j = plan.dp.size, plan.dp.rank
    w = shard.T if tied else shard                    # (d / g, V / m)
    blk = w.shape[0]
    xs = ops.all_gather(x.contiguous(), plan.dp, 0)[..., j * blk:
                                                   (j + 1) * blk]
    part = torch.matmul(xs.to(torch.float32), w.to(torch.float32))
    got = ops.all_to_all(torch.stack(part.chunk(g, 0)), plan.dp)
    return ops.ordered_sum(list(got), x.dtype)


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy over labels >= 0 of vocab-parallel
    ``logits`` (this rank's columns), in float32: the log-sum-exp from the
    ranks' sums of exp(l - M), M the largest logit over ``model``, and
    the gold logit from the rank whose block holds it, each summed over
    ``model``."""
    ax, lo, n = vocab()
    lf = logits.to(torch.float32)
    with torch.no_grad():
        top = ops.all_gather(lf.amax(-1)[None].contiguous(), ax, 0).amax(0)
    se = ops.psum(torch.exp(lf - top[..., None]).sum(-1), ax)
    lse = top + torch.log(se)
    idx = labels.clamp(min=0) - lo
    mine = (idx >= 0) & (idx < n)
    got = torch.gather(lf, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    gold = ops.psum(torch.where(mine, got, torch.zeros_like(got)), ax)
    mask = (labels >= 0).to(torch.float32)
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def argmax(logits: torch.Tensor) -> torch.Tensor:
    """The index of the largest of the last dimension of ``logits``, over
    the vocabulary's blocks when they are split (the largest value, the
    lower index on a tie, as ``jnp.argmax``); int64."""
    v = vocab()
    if v is None:
        return torch.argmax(logits, dim=-1)
    ax, lo, _ = v
    val, idx = torch.max(logits.to(torch.float32), dim=-1)
    both = torch.stack([val, (idx + lo).to(torch.float32)])
    parts = ops.all_gather(both[None].contiguous(), ax, 0)
    best, at = parts[0, 0], parts[0, 1]
    for r in range(1, parts.shape[0]):
        more = parts[r, 0] > best
        best = torch.where(more, parts[r, 0], best)
        at = torch.where(more, parts[r, 1], at)
    return at.to(torch.int64)


def decode_block(s_local: int) -> int | None:
    """The first position of this rank's block of a decode cache of
    ``s_local`` positions, when the ``model`` ranks hold blocks of the
    cache's positions; None when the cache is whole here."""
    plan = current()
    if plan is None or s_local not in plan.blocks:
        return None
    return plan.model.rank * s_local


def whole_length(s_local: int) -> int:
    """The length of the decode cache whose block here is ``s_local``
    positions long (``s_local`` where the cache is whole here)."""
    plan = current()
    return s_local if plan is None else plan.blocks.get(s_local, s_local)


def merge_parts(outs, lses):
    """Outputs (G, ...) and log-sum-exps (G, ...) of the same queries over
    G disjoint blocks of keys -> the output over all the keys, folded in
    block order in float32: sum_r out_r e^(lse_r - M) / sum_r e^(lse_r -
    M), M the largest lse (a block with no keys has lse -inf, weight 0)."""
    top = lses.amax(0)
    num = torch.zeros_like(outs[0])
    den = torch.zeros_like(lses[0])
    for o, s in zip(outs, lses):
        w = torch.exp(s - top)
        num = num + o * w[..., None]
        den = den + w
    return num / den[..., None]


def combine(out: torch.Tensor | None, lse: torch.Tensor | None, shape,
            dtype, device) -> torch.Tensor:
    """Merge each ``model`` rank's attention over its block of positions:
    ``out`` (B, 1, H, Dv) and ``lse`` (B, H), or None on a rank whose
    block holds no filled position (lse -inf). One all-gather over
    ``model`` of B H (Dv + 1) floats, then :func:`merge_parts` in rank
    order; the result (B, 1, H, Dv) in ``dtype``."""
    B, _, H, Dv = shape
    if out is None:
        part = torch.zeros((B, H, Dv + 1), dtype=torch.float32,
                           device=device)
        part[..., Dv] = -torch.inf
    else:
        part = torch.cat([out.reshape(B, H, Dv).to(torch.float32),
                          lse[..., None]], dim=-1)
    parts = ops.all_gather(part[None].contiguous(), current().model, 0)
    merged = merge_parts(parts[..., :Dv], parts[..., Dv])
    return merged.reshape(B, 1, H, Dv).to(dtype)
