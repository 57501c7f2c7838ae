"""Mixture-of-Experts FFN: the port of the JAX package's ``models/moe.py``,
its dense dispatch and its two expert-parallel (EP) lowerings.

Token-choice top-k routing: a float32 router softmax over the E experts,
the k largest gates of each token (ties to the lower expert id, as
``lax.top_k``), renormalised to sum to one, and the Switch-style
load-balance loss. Dense dispatch sorts the N x k (token, expert) pairs by
expert, stably, and gives each pair its position within its expert; the
first C = max(1, ceil(N k / E x capacity_factor)) pairs of an expert go to
its rows of an (E, C, d) buffer, the rest are dropped. A dropped pair
writes into one sink row past the buffer, which is cut off before the
experts run (JAX's ``mode="drop"`` scatter), so neither its value nor its
gradient reaches anything. The experts run as batched products
(``layers.mlp_einsum``), each pair's row comes back in the pairs' order
(zero where dropped), and the k rows of a token are summed with its gate
weights in x's dtype, plus the shared expert.

``moe_forward`` takes an EP path under ``parallel.sharding.axis_rules(
rules, mesh)`` with a ``DeviceMesh`` whose ``model`` axis G is wider than
1, when E divides by G and the tokens divide (JAX's selection); otherwise
the dense dispatch. The EP paths run one rank a device, as JAX's
``shard_map`` bodies run one device each, and take what this rank holds:
``x`` its block of the batch (the batch split over the rules' ``batch``
axes, replicated over ``model``, as ``launch.steps.batch_pspecs`` splits
it: JAX's N is dp_size times this rank's), ``router/w`` its (d / dp, E)
shard and each expert leaf its E / G experts with d split over the dp
axes (``param_pspecs``), the shared expert whole. They never gather the
expert stack over ``model``. ``EP_MODE`` picks the lowering:

* ``"replicated"`` (``_moe_forward_ep``): every model column routes its
  dp block's tokens, keeps the pairs bound for its E / G local experts in
  bins of c_exp = max(1, ceil(N_loc k cf / E)) rows, routing indices, not
  rows (slot -> token maps of length R + 1, the last a sink), runs its
  experts (all-gathered over dp only) and adds its partial combine; one
  sum over ``model`` completes y. ``aux`` is the mean over ``model`` of
  the dp means. JAX marks the replicated tokens and router weight as
  varying over ``model`` (``pcast``), so that their gradients are summed
  over ``model``: here ``axis_ops.varying``.
* ``"a2a"`` (``_moe_forward_ep_a2a``): each rank takes its 1 / G of its dp
  block's tokens, bins its pairs by destination group (c_send rows a
  group), sends rows and local expert ids to its model peers (two
  all-to-alls), bins what it receives by local expert (c_exp rows), runs
  its experts and sends the rows back (one all-to-all); ``aux`` from means
  over every axis.

Capacity is enforced per shard (GShard/Switch semantics), so drops can
differ from the dense path's; with capacity enough the paths agree to
rounding. The collectives are ``collectives.axis_ops``'s, each with its
transpose as its gradient. Without a mesh, or where the EP conditions
fail, the dense dispatch runs on what it is given, which is JAX's dense
dispatch only for the whole batch and every expert. Decode keeps the dense
semantics too: its capacity is reckoned from the B tokens of a step, so
with B > 1 pairs can drop where a prefill of the same tokens drops none,
as in JAX.

Initial values are the port's own (``layers`` docstring); an (E, ...)
expert leaf is drawn expert by expert into the leaf, so no float32 copy
of a whole leaf exists (kimi-k2's would be 22.5 GB).
"""
from __future__ import annotations

import math

import torch

from ..collectives import axis_ops as ops
from ..parallel.sharding import cs, current_mesh, current_rules
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


#: EP lowering selector: "replicated" routes every model column over its dp
#: block's tokens and combines expert groups with one sum over ``model``;
#: "a2a" exchanges token rows across the model axis with all-to-alls.
EP_MODE = "replicated"


def ep_axes(mesh, rules) -> tuple[int, tuple, int]:
    """(G, the dp axes, dp_size) of ``mesh`` under ``rules``: G the
    ``model`` axis's size, the dp axes the rules' ``batch`` axes, dp_size
    the mesh's other ranks (JAX: ``n_dev // G``), which they must cover."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    G = sizes.get("model", 1)
    n_dev = 1
    for v in sizes.values():
        n_dev *= v
    dp = rules.get("batch") or ()
    dp = dp if isinstance(dp, tuple) else (dp,)
    dp_size = max(1, n_dev // G)
    covered = 1
    for a in dp:
        covered *= sizes[a]
    if covered != dp_size:
        raise ValueError(f"expert parallelism splits the batch over the "
                         f"rules' batch axes {dp}; they cover {covered} of "
                         f"the mesh's {dp_size} non-model ranks")
    return G, dp, dp_size


def ep_mode(n_tokens: int, cfg: ModelConfig, mesh=None, rules=None):
    """The lowering ``moe_forward`` takes for ``n_tokens`` tokens on this
    rank: ``"replicated"``, ``"a2a"`` or None (dense dispatch), by JAX's
    rules on JAX's N = dp_size x ``n_tokens``."""
    mesh = current_mesh() if mesh is None else mesh
    rules = current_rules() if rules is None else rules
    if mesh is None or rules is None:
        return None
    G, _, dp_size = ep_axes(mesh, rules)
    if G > 1 and cfg.n_experts % G == 0:
        n = n_tokens * dp_size
        if EP_MODE == "a2a" and n % (dp_size * G) == 0:
            return "a2a"
        if EP_MODE == "replicated" and n % dp_size == 0:
            return "replicated"
    return None


def moe_forward(p, x, cfg: ModelConfig):
    """x: (B, T, d) -> (out, aux_loss). Dispatch-path selection
    (:func:`ep_mode`)."""
    B, T, _ = x.shape
    mode = ep_mode(B * T, cfg)
    if mode == "a2a":
        return _moe_forward_ep_a2a(p, x, cfg, current_mesh(),
                                   current_rules())
    if mode == "replicated":
        return _moe_forward_ep(p, x, cfg, current_mesh(), current_rules())
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
    xt = cs(x.reshape(N, d), "tokens_flat", None)
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
    xbuf = cs(xbuf[:E * C].view(E, C, d), "experts", "expert_cap", None)
    ybuf = mlp_einsum(p["experts"], xbuf, cfg)
    del xbuf
    ybuf = cs(ybuf, "experts", "expert_cap", None).reshape(E * C, d)

    # ---- combine: back in the pairs' order, weighted in x's dtype --------
    y_sorted = torch.where(keep[:, None], ybuf[dest.clamp(max=E * C - 1)], 0)
    del ybuf
    y_flat = torch.zeros_like(y_sorted).index_put_((order,), y_sorted)
    del y_sorted
    y = torch.einsum("nkd,nk->nd", y_flat.view(N, k, d), gate_w.to(x.dtype))
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt, cfg)
    y = cs(y, "tokens_flat", None)
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


# ---------------------------------------------------------------------------
# Expert parallelism: one rank a device (JAX's shard_map interiors)
# ---------------------------------------------------------------------------

def _gathered_experts(experts, dpa):
    """This rank's experts with d gathered over the dp axes (``w_down`` on
    dimension 2, the others on 1)."""
    return {name: ops.all_gather(w, dpa, 2 if name == "w_down" else 1)
            for name, w in experts.items()}


def _moe_forward_ep(p, x, cfg: ModelConfig, mesh, rules):
    """Replicated-routing EP: tokens stay dp-split end to end.

    Every rank of a model row holds the same N_loc tokens. Each model
    column g routes them, keeps only the pairs destined to its E / G local
    experts, runs them, and contributes a partial combine; one sum over
    ``model`` completes it. Routing (softmax and top-k over E) is
    computed G times, and no activation changes layout.
    """
    B, T, d = x.shape
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    G, dp, _ = ep_axes(mesh, rules)
    E_loc = E // G
    N_loc = B * T                       # JAX's N // dp_size
    c_exp = max(1, math.ceil(N_loc * k * cf / E))
    model, dpa = ops.axis(mesh, "model"), ops.axis(mesh, dp)

    xt = cs(x.reshape(N_loc, d), "batch", None)
    rw_full = ops.all_gather(p["router"]["w"], dpa, 0)
    wf = _gathered_experts(p["experts"], dpa)
    # The tokens and router weight are equal on every model column; their
    # gradients are summed over ``model`` (JAX's pcast to varying).
    xt = ops.varying(xt, model)
    rw_full = ops.varying(rw_full, model)
    gates = torch.softmax(xt.to(torch.float32) @ rw_full, dim=-1)
    gw, eidx = top_k(gates, k)
    gw = gw / torch.clamp(gw.sum(-1, keepdim=True), min=1e-9)

    # every column computes equal aux terms; the mean over ``model``
    # returns that value and scales each column's cotangent by 1 / G
    me = ops.pmean(gates.mean(0), dpa)
    F = N_loc * k
    flat_e = eidx.reshape(F)
    ce = ops.pmean(_count(flat_e, E, torch.float32) / F, dpa)
    aux = ops.pmean(E * torch.sum(me * ce), model)

    # route indices, not rows: slot -> source token and gate weight
    lb = flat_e - model.rank * E_loc
    local_bin = torch.where((lb >= 0) & (lb < E_loc), lb, E_loc)
    order, dest, _ = _sort_into_bins(local_bin, E_loc, c_exp)
    R = E_loc * c_exp
    tok_slot = torch.full((R + 1,), N_loc, dtype=torch.int64,
                          device=x.device).index_put_((dest,),
                                                      order // k)[:-1]
    gw_slot = gw.new_zeros((R + 1,)).index_put_(
        (dest,), gw.reshape(F)[order])[:-1]
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    yexp = mlp_einsum(wf, x_pad[tok_slot].view(E_loc, c_exp, d), cfg)
    contrib = yexp.reshape(R, d) * gw_slot[:, None].to(x.dtype)
    y = x.new_zeros((N_loc + 1, d)).index_add(0, tok_slot, contrib)[:-1]
    y = ops.psum(y, model).reshape(B, T, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return cs(y, "batch", "seq", None), aux


def _moe_forward_ep_a2a(p, x, cfg: ModelConfig, mesh, rules):
    """All-to-all EP: each rank routes its 1 / G of its dp block's tokens
    and exchanges rows with its model peers."""
    B, T, d = x.shape
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    G, dp, _ = ep_axes(mesh, rules)
    E_loc = E // G
    N_loc = B * T // G                  # JAX's N // n_dev
    # per-shard capacities (GShard-style; slack at both levels)
    c_send = max(1, math.ceil(N_loc * k * cf / G))
    c_exp = max(1, math.ceil(G * c_send * cf / E_loc))
    model, dpa = ops.axis(mesh, "model"), ops.axis(mesh, dp)
    every = ops.axis(mesh, dp + ("model",))

    xt = ops.own_slice(cs(x.reshape(B * T, d), "tokens_flat", None), model)
    rw_full = ops.varying(ops.all_gather(p["router"]["w"], dpa, 0), model)
    wf = _gathered_experts(p["experts"], dpa)
    gates = torch.softmax(xt.to(torch.float32) @ rw_full, dim=-1)
    gw, eidx = top_k(gates, k)
    gw = gw / torch.clamp(gw.sum(-1, keepdim=True), min=1e-9)

    # aux loss: global means over every mesh axis
    F = N_loc * k
    flat_e = eidx.reshape(F)
    me = ops.pmean(gates.mean(0), every)
    ce = ops.pmean(_count(flat_e, E, torch.float32) / F, every)
    aux = E * torch.sum(me * ce)

    # ---- send side: bin routed pairs by destination EP group ------------
    order, dest, keep = _sort_into_bins(flat_e // E_loc, G, c_send)
    rows = G * c_send
    send_x = x.new_zeros((rows + 1, d)).index_put_((dest,),
                                                   xt[order // k])[:-1]
    send_e = torch.full((rows + 1,), E_loc, dtype=torch.int64,
                        device=x.device).index_put_(
        (dest,), flat_e[order] % E_loc)[:-1]

    # ---- exchange rows with model-axis peers ------------------------------
    recv_x = ops.all_to_all(send_x.view(G, c_send, d), model)
    recv_e = ops.all_to_all(send_e.view(G, c_send), model)

    # ---- group received rows by local expert ------------------------------
    order2, dest2, keep2 = _sort_into_bins(recv_e.reshape(rows), E_loc,
                                           c_exp)
    S = E_loc * c_exp
    xexp = x.new_zeros((S + 1, d)).index_put_(
        (dest2,), recv_x.reshape(rows, d)[order2])[:-1]
    yexp = mlp_einsum(wf, xexp.view(E_loc, c_exp, d), cfg).reshape(S, d)

    # ---- ungroup, return rows, combine ------------------------------------
    y_sorted = torch.where(keep2[:, None], yexp[dest2.clamp(max=S - 1)], 0)
    y_rows = torch.zeros_like(y_sorted).index_put_((order2,), y_sorted)
    back = ops.all_to_all(y_rows.view(G, c_send, d), model)
    y_slot = torch.where(keep[:, None],
                         back.reshape(rows, d)[dest.clamp(max=rows - 1)], 0)
    y_pairs = x.new_zeros((F, d)).index_put_((order,), y_slot)
    y = torch.einsum("nkd,nk->nd", y_pairs.view(N_loc, k, d),
                     gw.to(x.dtype))
    # back to the dp block's (batch, seq) layout, equal on every column
    y = cs(ops.all_gather_invariant(y, model).reshape(B, T, d), "batch",
           "seq", None)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], cs(x, "batch", "seq", None), cfg)
    return y, aux
