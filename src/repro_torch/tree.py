"""Parameter trees: nested dicts (and lists) of tensors, keyed like the JAX
package's pytrees.

A leaf's path is its keys joined by ``/`` (``layers/attn/w_q``), which is
also its checkpoint key. Leaves are visited in sorted key order, as
``jax.tree.leaves`` visits a dict, so per-leaf sums over a tree add in the
JAX package's order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def leaves_with_paths(tree: Any,
                      prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in JAX order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(flat: dict[str, Any], like: Any = None) -> Any:
    """{"a/b": leaf} -> {"a": {"b": leaf}}.

    With ``like`` the result has ``like``'s structure, its lists kept lists
    (``blocks/0/...`` back into ``blocks[0]``), as ``jax.tree.map`` keeps
    them; every path of ``like`` must be in ``flat``. Without it every
    level is a dict."""
    if like is not None:
        return _rebuild(like, flat, "")
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def _rebuild(like: Any, flat: dict[str, Any], prefix: str) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return flat[prefix[:-1]]


def size(tree: Any) -> int:
    """Number of scalars in the tree's leaves."""
    return sum(leaf.numel() for leaf in leaves(tree))


def nbytes(tree: Any) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in leaves(tree)
               if isinstance(leaf, torch.Tensor))
