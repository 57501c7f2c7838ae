"""Logical-axis sharding rules (MaxText-style): the port of the JAX
package's ``parallel/sharding.py``.

Model code annotates activations with *logical* axis names via ``cs(x,
...)``; a launcher installs an :class:`AxisRules` mapping logical names to
mesh axes, and the mesh beside them (a ``torch.distributed`` ``DeviceMesh``
here, a ``jax.sharding.Mesh`` there). Without installed rules every
annotation is a no-op, so the same model code runs in single-process tests
and one rank a device.

A spec is a :class:`PartitionSpec`: a tuple with one entry per tensor
dimension, each ``None`` (not sharded), a mesh axis name, or a tuple of
names (the dimension split over several axes, the first the major one).
It normalises its entries as JAX's does (a 1-tuple becomes its name, an
empty tuple ``None``), so a port spec compares equal, entry for entry, to
the JAX ``PartitionSpec`` of the same leaf. :func:`placements` turns a spec
into DTensor placements on a ``DeviceMesh``.

Parameter shardings are assigned by leaf-path regex
(``param_sharding_specs``), first match wins, so any parameter tree the
model inits produce gets a complete sharding without per-module plumbing.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Any

from torch.distributed.tensor import DTensor, Replicate, Shard

from . import layer_gather

_STATE = threading.local()


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None``, a mesh axis name, or a
    tuple of names; ``PartitionSpec()`` replicates every dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AxisRules(dict):
    """logical axis name -> mesh axis (str | tuple | None)."""


# Default production rules: batch over (pod, data); model-parallel dims over
# `model`; FSDP weight shard over (pod, data).
def make_rules(multi_pod: bool, seq_shard: bool = False,
               fsdp: bool = True) -> AxisRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    return AxisRules(
        batch=dp,
        seq="model" if seq_shard else None,   # SP: shard long sequences
        embed=None,
        heads="model",
        kv_heads="model",
        ff="model",
        vocab="model",
        experts="model",
        expert_cap=None,
        fsdp=dp if fsdp else None,
        tokens_flat=dp + ("model",),          # MoE dispatch: full flattening
        state="model",
    )


@contextlib.contextmanager
def axis_rules(rules: AxisRules | None, mesh=None):
    """Install ``rules`` and ``mesh`` for this thread; the previous ones
    come back on exit (nested contexts too)."""
    prev = getattr(_STATE, "rules", None)
    prev_mesh = getattr(_STATE, "mesh", None)
    _STATE.rules = rules
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.rules = prev
        _STATE.mesh = prev_mesh


def checkpoint_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute in the
    backward runs under the rules, mesh and layer-gather plan
    (``layer_gather.installed``) installed at the forward. The backward of
    CUDA tensors runs on autograd's own threads, which see none of them; a
    recomputed MoE layer would take the dense dispatch there, and a layer
    would not gather its shards."""
    return contextlib.nullcontext(), _recompute(
        current_rules(), current_mesh(), layer_gather.current())


@contextlib.contextmanager
def _recompute(rules, mesh, plan):
    with axis_rules(rules, mesh), layer_gather.installed(plan):
        yield


def current_rules() -> AxisRules | None:
    return getattr(_STATE, "rules", None)


def current_mesh():
    """Mesh installed alongside the rules (for the expert-parallel
    interiors)."""
    return getattr(_STATE, "mesh", None)


def logical_spec(*names: str | None) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return P()
    return P(*[rules.get(n) if n else None for n in names])


def placements(mesh, spec, ndim: int) -> tuple:
    """DTensor placements of a tensor of ``ndim`` dimensions under
    ``spec`` on ``mesh``: ``Shard(dim)`` on each mesh dimension that the
    spec names for tensor dimension ``dim``, ``Replicate()`` elsewhere.

    A tensor dimension split over several mesh axes takes them in the
    spec's order, the first the major one, as a ``NamedSharding`` does;
    DTensor splits in mesh-dimension order, so the spec's order must be
    the mesh's (it is, for every rule here)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"spec {spec} uses axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(dim)
    return tuple(out)


def cs(x, *names: str | None):
    """Constrain activation sharding by logical axis names: the identity
    without rules and on a plain tensor; a DTensor under installed rules
    and a ``DeviceMesh`` is redistributed to the logical spec's placements
    (the same values)."""
    rules = current_rules()
    mesh = current_mesh()
    if rules is None or mesh is None:
        return x
    if not isinstance(x, DTensor):
        return x
    want = placements(mesh, logical_spec(*names), x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# Parameter shardings by leaf path
# ---------------------------------------------------------------------------

# Order matters: first match wins. Patterns run against '/'-joined tree paths.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r".*embed_tokens$",           ("vocab", "fsdp")),
    (r".*lm_head$",                ("fsdp", "vocab")),
    (r".*pos_embed$",              (None, "fsdp")),
    # MoE expert stacks: (E, d, ff) / (E, ff, d)
    (r".*experts/w_(gate|up)$",    ("experts", "fsdp", None)),
    (r".*experts/w_down$",         ("experts", None, "fsdp")),
    (r".*router/w$",               ("fsdp", None)),
    # attention projections
    (r".*w_q$|.*w_uq$",            ("fsdp", "heads")),
    (r".*w_(k|v)$",                ("fsdp", "heads")),
    (r".*w_o$",                    ("heads", "fsdp")),
    (r".*w_dq$|.*w_dkv$",          ("fsdp", None)),
    (r".*w_ukv$",                  (None, "heads")),
    # dense MLPs: (d, ff) / (ff, d)
    (r".*w_(gate|up)$",            ("fsdp", "ff")),
    (r".*w_down$",                 ("ff", "fsdp")),
    # SSM mixers
    (r".*ssm/(w_in|w_x)$",         ("fsdp", "heads")),
    (r".*ssm/w_out$",              ("heads", "fsdp")),
    (r".*ssm/.*$",                 (None,)),
    (r".*mix/(w_in|out_gate)$",    ("fsdp", "heads")),
    # norms / scalars / everything else: replicated
    (r".*",                        ()),
]


def _spec_for_path(path: str, rules: AxisRules,
                   stacked: bool) -> PartitionSpec:
    for pat, names in _PARAM_RULES:
        if re.fullmatch(pat, path):
            axes = [rules.get(n) if n else None for n in names]
            if stacked:
                axes = [None] + axes  # leading stacked-layer axis
            return P(*axes)
    return P()


def _path_str(path) -> str:
    """A key path as ``a/b/0/c``: strings, or JAX's key entries (``.key``,
    ``.idx``)."""
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def param_sharding_specs(params: Any, rules: AxisRules,
                         stacked_prefixes: tuple = ("layers",)) -> Any:
    """PartitionSpec tree matching ``params`` (nested dicts and lists of
    tensors; the leaves need only ``ndim``).

    Leaves under a subtree named in ``stacked_prefixes`` (the stacked
    layers) get a leading None axis for the layer dimension; a spec longer
    than its leaf is cut to the leaf's rank.
    """

    def leaf_spec(path, leaf):
        ps = _path_str(path)
        stacked = any(f"/{sp}/" in f"/{ps}/" for sp in stacked_prefixes)
        spec = _spec_for_path(ps, rules, stacked)
        ndim = getattr(leaf, "ndim", 0)
        if len(spec) > ndim:
            spec = P(*list(spec)[:ndim])
        return spec

    return map_with_path(leaf_spec, params)


def map_with_path(fn, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists, the path's keys
    joined by ``/``; a :class:`PartitionSpec` is a leaf, not a tuple to
    descend into."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(map_with_path(fn, v, f"{path}{i}/")
                          for i, v in enumerate(tree))
    return fn(path[:-1], tree)


def map_specs(fn, specs: Any, *rest: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    return type(specs)(map_specs(fn, v, *(r[i] for r in rest))
                       for i, v in enumerate(specs))
