"""Recurrent mixers: the port of the JAX package's ``models/ssm.py``:
xLSTM's mLSTM and sLSTM, and the Mamba-style selective SSM (hymba's SSM
heads), for training, prefill and decode.

mLSTM is the chunkwise-parallel form, chunk by chunk in JAX's order: the
intra-chunk terms dense, the state carried across chunks; q, k and v in
the model's dtype, the gates, scores, decay matrix and states in float32,
and ``mlstm_forward`` asserts that T is a multiple of the chunk, as JAX
does. One change: the decay matrix's exponential reads 0 above the
diagonal before it is taken (``_mlstm_chunk``), so the masked entries,
which overflow to inf at long chunks, give a zero gradient where JAX's
``jnp.where`` gives NaN; the forward is the same. sLSTM is a sequential
loop over t with float32 states. Both decode one token and write their
states in place.

Mamba: the parameter tree and the arithmetic are the JAX model's: the
input projection in the model's dtype, then everything of the scan in
float32 (one delta per (b, t), from the last column of the (2N + 1)-wide
projection and ``dt_bias[0]``, as the JAX model computes it, so
``dt_bias[1:]`` gets a zero gradient), the skip term, the ``silu(z)``
gate, and the output projection in the model's dtype. The scan itself runs
through ``kernels.ssm_scan.ops`` (the CUDA kernels on the card, the plain
versions on CPU tensors) in ``mamba_forward`` and ``mamba_decode``; under
autograd it is the ``SSMScan`` function: on the card its forward also
writes the state at the start of every 32-step run, which it saves, and
its backward kernels rebuild each run's states from those checkpoints and
walk segments of T in parallel; the epilogue then runs out of place.
``mamba_forward_sequential`` with ``_mamba_step`` is the plain
per-timestep oracle. The state is float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ssm_scan.ops import ssm_chunk_scan
from .config import ModelConfig
from .layers import dense_init, dtype_of


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM): chunkwise-parallel
# ---------------------------------------------------------------------------

def _sqrt_hd(cfg: ModelConfig, dtype) -> float:
    """sqrt(hd) as JAX divides by it: float32, then the operand's dtype."""
    r = torch.tensor(float(np.sqrt(np.float32(cfg.hd))), dtype=torch.float32)
    return float(r.to(dtype))


def init_mlstm(gen, cfg: ModelConfig):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dt = dtype_of(cfg)
    return {
        "w_q": dense_init(gen, (d, H * hd), dt),
        "w_k": dense_init(gen, (d, H * hd), dt),
        "w_v": dense_init(gen, (d, H * hd), dt),
        "w_if": dense_init(gen, (d, 2 * H), dt),   # input & forget gates
        "w_o": dense_init(gen, (H * hd, d), dt),
        "out_gate": dense_init(gen, (d, H * hd), dt),
    }


def mlstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    H, hd = cfg.n_heads, cfg.hd
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"C": z(batch, H, hd, hd), "n": z(batch, H, hd)}


def _mlstm_chunk(C, n, q, k, v, ig, fg):
    """One chunk: q, k, v (B, c, H, hd) in the model's dtype; ig, fg
    (B, c, H) in (0, 1), float32; the carry C (B, H, hd, hd), n (B, H, hd)
    float32. Returns (C, n, h (B, c, H, hd) float32)."""
    c = q.shape[1]
    f32 = torch.float32
    logf = torch.log(fg + 1e-8)                              # (B, c, H)
    cumf = torch.cumsum(logf, dim=1)                         # prod f_1..t
    # inter-chunk: the state decayed to step t
    decay_to_t = torch.exp(cumf)
    h_inter = torch.einsum("bhde,bche->bchd", C, q.to(f32)) * \
        decay_to_t[..., None]
    n_inter = torch.einsum("bhd,bchd->bch", n, q.to(f32)) * decay_to_t
    # intra-chunk: D[t, s] = exp(cumf_t - cumf_s) * i_s for s <= t; above
    # the diagonal the difference is positive and its exp may overflow, so
    # it is zeroed first (the same forward, a finite gradient)
    dmat = cumf[:, :, None, :] - cumf[:, None, :, :]         # (B, t, s, H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    dmat = torch.where(tri, torch.exp(torch.where(tri, dmat, 0.0)), 0.0)
    dmat = dmat * ig[:, None, :, :]                          # * i_s
    scores = torch.einsum("bthd,bshd->btsh", q, k).to(f32)
    w = scores * dmat
    h_intra = torch.einsum("btsh,bshd->bthd", w.to(v.dtype), v)
    n_intra = torch.einsum("btsh,bshd->bth", w, k.to(f32))
    h = h_inter + h_intra
    norm = torch.clamp(torch.abs(n_inter + n_intra), min=1.0)[..., None]
    h = h / norm
    # the carry
    decay_all = torch.exp(cumf[:, -1])                       # (B, H)
    w_end = torch.exp(cumf[:, -1:, :] - cumf) * ig           # (B, c, H)
    C = C * decay_all[..., None, None] + torch.einsum(
        "bch,bchd,bche->bhde", w_end, v.to(f32), k.to(f32))
    n = n * decay_all[..., None] + torch.einsum(
        "bch,bchd->bhd", w_end, k.to(f32))
    return C, n, h


def mlstm_forward(p, x, cfg: ModelConfig, state=None):
    """x (B, T, d), T a multiple of the chunk min(chunk_size, T) -> (out
    (B, T, d), {"C", "n"} the final state)."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    c = min(cfg.chunk_size, T)
    assert T % c == 0, "caller must pad to chunk multiple"
    sq = _sqrt_hd(cfg, x.dtype)
    q = (x @ p["w_q"]).reshape(B, T, H, hd) / sq
    k = (x @ p["w_k"]).reshape(B, T, H, hd) / sq
    v = (x @ p["w_v"]).reshape(B, T, H, hd)
    gates = torch.sigmoid((x @ p["w_if"]).to(torch.float32))
    ig, fg = gates[..., :H], gates[..., H:]
    st = state or mlstm_state(cfg, B, x.device)
    C, n = st["C"], st["n"]
    hs = []
    for j in range(0, T, c):
        C, n, h = _mlstm_chunk(C, n, *(a[:, j:j + c] for a in (q, k, v, ig,
                                                              fg)))
        hs.append(h)
    h = torch.cat(hs, 1).reshape(B, T, H * hd).to(x.dtype)
    h = h * torch.sigmoid(x @ p["out_gate"])
    return h @ p["w_o"], {"C": C, "n": n}


def mlstm_decode(p, x, state, cfg: ModelConfig):
    """One token, x (B, 1, d): the recurrent update, the new state written
    into ``state`` in place (JAX returns a new state). Returns (out
    (B, 1, d), state)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    sq = _sqrt_hd(cfg, f32)
    q = (x @ p["w_q"]).reshape(B, H, hd).to(f32) / sq
    k = (x @ p["w_k"]).reshape(B, H, hd).to(f32) / sq
    v = (x @ p["w_v"]).reshape(B, H, hd).to(f32)
    gates = torch.sigmoid((x @ p["w_if"]).to(f32)).reshape(B, 2 * H)
    ig, fg = gates[:, :H], gates[:, H:]
    C = state["C"] * fg[..., None, None] + \
        ig[..., None, None] * v[..., :, None] * k[..., None, :]
    n = state["n"] * fg[..., None] + ig[..., None] * k
    h = torch.einsum("bhde,bhe->bhd", C, q)
    norm = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), min=1.0)
    h = (h / norm[..., None]).reshape(B, 1, H * hd).to(x.dtype)
    h = h * torch.sigmoid(x @ p["out_gate"])
    state["C"].copy_(C)
    state["n"].copy_(n)
    return h @ p["w_o"], state


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with recurrent gates): sequential
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg: ModelConfig):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dt = dtype_of(cfg)
    return {
        "w_in": dense_init(gen, (d, 4 * H * hd), dt),          # z, i, f, o
        "r": dense_init(gen, (H, hd, 4 * hd), dt, scale=0.5),  # block-diag
        "w_o": dense_init(gen, (H * hd, d), dt),
    }


def slstm_state(cfg: ModelConfig, batch: int, device="cuda"):
    z = lambda: torch.zeros((batch, cfg.n_heads, cfg.hd),
                            dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z()}


def _slstm_step(r32, c, n, h, u32, out=(None,) * 5):
    """One step, head-major: r32 (H, hd, 4 hd) the recurrent weights in
    float32, the carry c, n, h (H, B, hd) float32, u32 (H, B, 4 hd) the
    input projection in float32. Returns (c, n, h, z, the gates i, f, o as
    one (H, B, 3 hd) tensor), each written into its tensor of ``out``
    where that is not None. The three sigmoids are one call over the
    contiguous gates: the same values as three."""
    hd = h.shape[-1]
    oc, on, oh, oz, og = out
    pre = u32 + torch.bmm(h, r32)
    z = torch.tanh(pre[..., :hd], out=oz)
    g = torch.sigmoid(pre[..., hd:], out=og)
    i, f, o = g[..., :hd], g[..., hd:2 * hd], g[..., 2 * hd:]
    c = torch.add(f * c, i * z, out=oc)
    n = torch.add(f * n, i, out=on)
    h = torch.div(o * c, torch.clamp(n, min=1.0), out=oh)
    return c, n, h, z, g


class SLSTMScan(torch.autograd.Function):
    """The sLSTM over a sequence: (u (B, T, H, 4 hd) in the model's dtype,
    r (H, hd, 4 hd), c0, n0, h0 (B, H, hd) float32) -> (hs (B, T, H, hd),
    c, n, h) float32. The forward is a loop of :func:`_slstm_step`
    (head-major, so the recurrent product is one ``bmm``); under autograd
    it keeps each step's states and gates, and the backward walks the
    steps in reverse with the adjoints of c, n and h, its four gate
    gradients one product with coefficients taken for every step at once,
    and r's gradient one contraction after the walk. Autograd through the
    loop would record some thirty operations a step and walk them one by
    one (xlstm-125m's training step on the card, PERF.md, PR 24)."""

    @staticmethod
    def forward(ctx, u, r, c, n, h):
        f32 = torch.promote_types(u.dtype, torch.float32)   # float64 too
        r32 = r.to(f32)
        u32 = u.to(f32).permute(1, 2, 0, 3).contiguous()     # (T, H, B, 4hd)
        t, nh, b, four = u32.shape
        hd = four // 4
        keep = any(ctx.needs_input_grad)       # keep every step's states
        new = lambda w: u32.new_empty((t, nh, b, w))
        cs, ns, hs, zs, gs = (new(hd), new(hd), new(hd), new(hd),
                              new(3 * hd)) if keep else (None, None,
                                                         new(hd), None, None)
        c0, n0, h0 = (x.transpose(0, 1) for x in (c, n, h))
        c, n, h = c0, n0, h0
        for k in range(t):
            outs = ((cs[k], ns[k], hs[k], zs[k], gs[k]) if keep
                    else (None, None, hs[k], None, None))
            c, n, h, _, _ = _slstm_step(r32, c, n, h, u32[k], outs)
        if keep:
            ctx.save_for_backward(r32, c0, n0, h0, cs, ns, hs, zs, gs)
        ctx.dtypes = (u.dtype, r.dtype)
        back = lambda x: x.transpose(0, 1)
        return hs.permute(2, 0, 1, 3), back(c), back(n), back(h)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_hs, g_c, g_n, g_h):
        r32, c0, n0, h0, cs, ns, hs, zs, gs = ctx.saved_tensors
        hd = hs.shape[-1]
        prev = lambda x0, xs: torch.cat([x0[None], xs[:-1]])
        c_prev, n_prev, h_prev = prev(c0, cs), prev(n0, ns), prev(h0, hs)
        i, f, o = gs[..., :hd], gs[..., hd:2 * hd], gs[..., 2 * hd:]
        m = torch.clamp(ns, min=1.0)
        # h = o c / m, m = clamp(n, 1): its partials, every step at once
        dh_dc = o / m
        dh_dn = -(o * cs) / (m * m) * (ns >= 1.0)
        # the gate gradients (z, i, f, o) as coefficients of (dc, dn, dH)
        zero = torch.zeros_like(cs)
        coef = torch.stack([
            torch.stack([i * (1 - zs * zs), zero, zero]),
            torch.stack([zs * i * (1 - i), i * (1 - i), zero]),
            torch.stack([c_prev * f * (1 - f), n_prev * f * (1 - f), zero]),
            torch.stack([zero, zero, cs / m * o * (1 - o)])], 3)
        del zero                           # coef: (3, T, H, 4, B, hd)
        g_pre = hs.new_empty(hs.shape[:2] + (4,) + hs.shape[2:])
        tr = lambda g: None if g is None else g.transpose(0, 1)
        g_hs = None if g_hs is None else g_hs.permute(1, 2, 0, 3)
        zero = lambda g: torch.zeros_like(c0) if g is None else tr(g)
        dc, dn, dh = zero(g_c), zero(g_n), zero(g_h)
        r32_t = r32.transpose(1, 2)
        for k in reversed(range(hs.shape[0])):
            dH = dh if g_hs is None else g_hs[k] + dh
            dc = dc + dH * dh_dc[k]
            dn = dn + dH * dh_dn[k]
            v = torch.stack((dc, dn, dH))[:, :, None]      # (3, H, 1, B, hd)
            torch.sum(coef[:, k] * v, 0, out=g_pre[k])
            dc, dn = dc * f[k], dn * f[k]
            # (H, 4, B, hd) -> (H, B, 4 hd) for the recurrent product
            dh = torch.bmm(g_pre[k].transpose(1, 2).reshape(dh.shape[0], -1,
                                                           4 * hd), r32_t)
        g_pre = g_pre.permute(3, 0, 1, 2, 4).flatten(3)    # (B, T, H, 4hd)
        g_r = torch.einsum("thbd,bthe->hde", h_prev, g_pre)
        u_dtype, r_dtype = ctx.dtypes
        return (g_pre.to(u_dtype), g_r.to(r_dtype), tr(dc), tr(dn), tr(dh))


def slstm_forward(p, x, cfg: ModelConfig, state=None):
    """x (B, T, d) -> (out (B, T, d), {"c", "n", "h"} the final state)."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    u = (x @ p["w_in"]).reshape(B, T, H, 4 * hd)
    st = state or slstm_state(cfg, B, x.device)
    hs, c, n, h = SLSTMScan.apply(u, p["r"], st["c"], st["n"], st["h"])
    out = hs.reshape(B, T, H * hd).to(x.dtype) @ p["w_o"]
    return out, {"c": c, "n": n, "h": h}


def slstm_decode(p, x, state, cfg: ModelConfig):
    """One token, x (B, 1, d); the new state written into ``state`` in
    place. Returns (out (B, 1, d), state)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    u = (x @ p["w_in"]).reshape(B, H, 4 * hd).transpose(0, 1)
    c, n, h, _, _ = _slstm_step(p["r"].to(torch.float32),
                                *(state[k].transpose(0, 1)
                                  for k in ("c", "n", "h")),
                                u.to(torch.float32))
    for key, val in (("c", c), ("n", n), ("h", h)):
        state[key].copy_(val.transpose(0, 1))
    return state["h"].reshape(B, 1, H * hd).to(x.dtype) @ p["w_o"], state


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (hymba's SSM heads)
# ---------------------------------------------------------------------------

def _d_inner(cfg: ModelConfig) -> int:
    return int(cfg.d_inner_mult * cfg.d_model)


def init_mamba(gen, cfg: ModelConfig, d_out: int | None = None):
    """The JAX tree's leaves; the projections drawn from ``gen``, a_log,
    d_skip and dt_bias at the JAX model's initial values."""
    d, di, N = cfg.d_model, _d_inner(cfg), cfg.ssm_state
    dt, dev = dtype_of(cfg), gen.device
    return {
        "w_in": dense_init(gen, (d, 2 * di), dt),            # u, z
        "w_bcdt": dense_init(gen, (di, 2 * N + 1), dt),      # B, C, dt
        "a_log": torch.zeros((di, N), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((di,), -4.0, dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (di, d_out or d), dt),
    }


def mamba_state(cfg: ModelConfig, batch: int, device="cuda"):
    return {"s": torch.zeros((batch, _d_inner(cfg), cfg.ssm_state),
                             dtype=torch.float32, device=device)}


def _delta(p, dt_raw):
    """softplus(dt_raw + dt_bias[0]): one delta per row, as in JAX."""
    return F.softplus(dt_raw + p["dt_bias"][:1])


def _mamba_step(p, s, u_t, z_t, N: int):
    """One timestep of the plain oracle. u_t, z_t: (B, di); s: (B, di, N).
    Returns (s, y (B, di) float32)."""
    uf = u_t.to(torch.float32)
    bcdt = (u_t @ p["w_bcdt"]).to(torch.float32)              # (B, 2N+1)
    bv, cv = bcdt[:, :N], bcdt[:, N:2 * N]
    delta = _delta(p, bcdt[:, -1:])                           # (B, 1)
    a = -torch.exp(p["a_log"])                                # (di, N)
    decay = torch.exp(delta[..., None] * a[None])             # (B, di, N)
    s = s * decay + (delta * uf)[..., None] * bv[:, None, :]
    y = torch.einsum("bdn,bn->bd", s, cv) + p["d_skip"] * uf
    return s, y * F.silu(z_t.to(torch.float32))


def mamba_forward_sequential(p, x, cfg: ModelConfig, state=None):
    """The plain per-timestep form (the JAX package's oracle for the
    chunked scan). x (B, T, d) -> (y (B, T, d_out), {"s"})."""
    b, t, _ = x.shape
    u, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    s = (state or mamba_state(cfg, b, x.device))["s"]
    ys = []
    for i in range(t):
        s, y = _mamba_step(p, s, u[:, i], z[:, i], cfg.ssm_state)
        ys.append(y)
    y = torch.stack(ys, 1).to(x.dtype) @ p["w_out"]
    return y, {"s": s}


def _mamba(p, x, cfg: ModelConfig, s0, s_out=None):
    """Projections, the scan kernel over all of x's T steps, epilogue."""
    N = cfg.ssm_state
    u, z = torch.chunk(x @ p["w_in"], 2, dim=-1)              # (B, T, di)
    bcdt = (u @ p["w_bcdt"]).to(torch.float32)                # (B, T, 2N+1)
    delta = _delta(p, bcdt[..., -1:])                         # (B, T, 1)
    a = -torch.exp(p["a_log"])
    uf = u.to(torch.float32)
    y, s = ssm_chunk_scan(uf, delta, bcdt[..., :N], bcdt[..., N:2 * N], a,
                          s0, s_out)
    if torch.is_grad_enabled():       # y is the scan function's output
        y = (y + p["d_skip"] * uf) * F.silu(z.to(torch.float32))
    else:
        y += p["d_skip"] * uf
        y *= F.silu(z.to(torch.float32))
    return y.to(x.dtype) @ p["w_out"], s


def mamba_forward(p, x, cfg: ModelConfig, state=None):
    """x (B, T, d) -> (y (B, T, d_out), {"s": final state}); the scan runs
    in one kernel launch for any T (JAX's chunked form needs T a multiple
    of ``chunk_size`` and takes the sequential form otherwise)."""
    s0 = (state or mamba_state(cfg, x.shape[0], x.device))["s"]
    y, s = _mamba(p, x, cfg, s0)
    return y, {"s": s}


def mamba_decode(p, x, state, cfg: ModelConfig):
    """One token, x (B, 1, d): the scan kernel with T = 1, the new state
    written into ``state["s"]`` in place (JAX returns a new state).
    Returns (y (B, 1, d_out), state)."""
    y, _ = _mamba(p, x, cfg, state["s"], s_out=state["s"])
    return y, state
