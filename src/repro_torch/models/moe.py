"""Mixture-of-Experts FFN: the port of the JAX package's ``models/moe.py``,
its dense dispatch.

Token-choice top-k routing: a float32 router softmax over the E experts,
the k largest gates of each token (ties to the lower expert id, as
``lax.top_k``), renormalised to sum to one, and the Switch-style
load-balance loss. Dispatch sorts the N x k (token, expert) pairs by
expert, stably, and gives each pair its position within its expert; the
first C = max(1, ceil(N k / E x capacity_factor)) pairs of an expert go to
its rows of an (E, C, d) buffer, the rest are dropped. A dropped pair
writes into one sink row past the buffer, which is cut off before the
experts run (JAX's ``mode="drop"`` scatter), so neither its value nor its
gradient reaches anything. The experts run as batched products
(``layers.mlp_einsum``), each pair's row comes back in the pairs' order
(zero where dropped), and the k rows of a token are summed with its gate
weights in x's dtype, plus the shared expert.

``moe_forward`` always takes this path. The JAX package's expert-parallel
lowerings (``_moe_forward_ep``, ``_moe_forward_ep_a2a``) run under a mesh
with a ``model`` axis, which waits for the port of ``parallel/sharding.py``
(ROADMAP A10: sharding). Decode keeps the dense semantics too: its
capacity is reckoned from the B tokens of a step, so with B > 1 pairs can
drop where a prefill of the same tokens drops none, as in JAX.

Initial values are the port's own (``layers`` docstring); an (E, ...)
expert leaf is drawn expert by expert into the leaf, so no float32 copy
of a whole leaf exists (kimi-k2's would be 22.5 GB).
"""
from __future__ import annotations

import math

import torch

from .config import ModelConfig
from .layers import apply_mlp, dense_init, dtype_of, init_mlp, mlp_einsum


def _experts_init(gen, shape, dtype):
    """``dense_init`` of an (E, ...) leaf, one expert's draw at a time."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = dense_init(gen, shape[1:], dtype)
    return out


def init_moe(gen, cfg: ModelConfig):
    """``router/w`` (d, E) float32, ``experts/{w_gate, w_up, w_down}``
    (E, d, f) and (E, f, d), and ``shared``, an MLP of width
    ``n_shared_experts * d_ff_expert``, when the config has one."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    dt = dtype_of(cfg)
    experts = {"w_up": _experts_init(gen, (E, d, f), dt),
               "w_down": _experts_init(gen, (E, f, d), dt)}
    if cfg.mlp_type == "swiglu":
        experts["w_gate"] = _experts_init(gen, (E, d, f), dt)
    p = {"router": {"w": dense_init(gen, (d, E), torch.float32, scale=0.1)},
         "experts": experts}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, cfg.n_shared_experts * f)
    return p


def moe_forward(p, x, cfg: ModelConfig):
    """x: (B, T, d) -> (out, aux_loss), by the dense dispatch (the port
    has no expert-parallel path yet)."""
    return _moe_forward_dense(p, x, cfg)


def top_k(gates: torch.Tensor, k: int):
    """The k largest of each row, descending, the lower index first among
    equal values (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, xt, cfg: ModelConfig):
    """xt (N, d) -> (gates (N, E) float32, gate_w (N, k) renormalised,
    eidx (N, k) expert ids)."""
    gates = torch.softmax(xt.to(torch.float32) @ p["router"]["w"], dim=-1)
    gate_w, eidx = top_k(gates, cfg.top_k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return gates, gate_w, eidx


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Rows an expert takes for ``n_tokens`` tokens, as the JAX package
    reckons them."""
    return max(1, math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor))


def _moe_forward_dense(p, x, cfg: ModelConfig):
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * T
    xt = x.reshape(N, d)
    gates, gate_w, eidx = route(p, xt, cfg)

    # ---- load-balance auxiliary loss (Switch-style) ----------------------
    me = gates.mean(0)                                          # (E,)
    flat_e = eidx.reshape(N * k)
    ce = _count(flat_e, E, torch.float32) / (N * k)
    aux = E * torch.sum(me * ce)

    # ---- sort-based dispatch ---------------------------------------------
    C = expert_capacity(N, cfg)
    order, dest, keep = _sort_into_bins(flat_e, E, C)
    # row E * C is the sink of every dropped pair, cut off below; the
    # scatters write in place into buffers made for them (an out-of-place
    # index_put would copy each)
    xbuf = x.new_zeros((E * C + 1, d)).index_put_((dest,), xt[order // k])
    ybuf = mlp_einsum(p["experts"], xbuf[:E * C].view(E, C, d), cfg)
    del xbuf
    ybuf = ybuf.reshape(E * C, d)

    # ---- combine: back in the pairs' order, weighted in x's dtype --------
    y_sorted = torch.where(keep[:, None], ybuf[dest.clamp(max=E * C - 1)], 0)
    del ybuf
    y_flat = torch.zeros_like(y_sorted).index_put_((order,), y_sorted)
    del y_sorted
    y = torch.einsum("nkd,nk->nd", y_flat.view(N, k, d), gate_w.to(x.dtype))
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt, cfg)
    return y.reshape(B, T, d), aux


def _count(ids: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``ids`` (``torch.bincount``
    reads the largest id back to the host on the card; this does not)."""
    return torch.zeros(n, dtype=dtype, device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=dtype, device=ids.device))


def _sort_into_bins(values_idx: torch.Tensor, n_bins: int, capacity: int):
    """Rank items by bin with a per-bin capacity (sort-based, no one-hot).

    values_idx: (R,) non-negative int bin id per item; ids >= n_bins are
    invalid/padding. Returns (order, dest, keep): items iterated in sorted
    order; item ``order[i]`` goes to flat slot ``dest[i]`` (bin * capacity
    + rank) when ``keep[i]``; overflow and invalid ids go to slot n_bins *
    capacity (dropped).
    """
    R = values_idx.shape[0]
    sorted_b, order = torch.sort(values_idx, stable=True)
    clipped = torch.clamp(sorted_b, max=n_bins)
    counts = _count(clipped, n_bins + 1, torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(R, device=values_idx.device) - starts[clipped]
    keep = (pos < capacity) & (sorted_b < n_bins)
    dest = torch.where(keep, sorted_b * capacity + pos, n_bins * capacity)
    return order, dest, keep
