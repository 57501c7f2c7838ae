"""The solve's two redesigned kernels, rehearsed on the CPU.

``csrc/levelfold.cu`` (the level fold) and ``csrc/minplus.cu``'s
``color_level_kernel`` (one level of the color: chains and budget split)
give each chain a group of g = pow2ceil(min(K, 32)) lanes, carry many nodes
a block, fold a run of sentinel (identity) children in closed form and
never run a K*K step against the identity. The twins below repeat that
schedule in torch, lane group by lane group: the launchers' geometry, the
ballot compaction of real children, the top-chunk-first in-place step, the
shuffle-up prefix minimum, the closed-form identity run, the segmented
epilogue and the butterfly argmin. They are held bitwise (tolerance 0)
against the plain versions (``level_fold_torch``, ``color_level_torch``)
and through them against the JAX package, on forests whose max_children
is 128 (a hub) and 2 (a binary tree), on random rows holding BIG and
entries above it (2e18), with interleaved sentinels. Every comparison is
bitwise: each candidate is one rounded add, min is exact in any order, and
the closed form is exact (see ``identity_steps``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.engine import solve_batch as j_solve_batch
from repro.kernels.minplus import levelfold as jlf
from repro_torch import core as tcore
from repro_torch.core.tropical import BIG
from repro_torch.engine import EngineOptions, batched, solve_batch
from repro_torch.kernels.minplus.color import color_level_torch
from repro_torch.kernels.minplus.levelfold import (identity_steps,
                                                   level_fold_torch,
                                                   minplus_fused)

CPU = EngineOptions(device="cpu")
INF = float("inf")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the closed-form identity step -------------------------------------------

def _rows(rng, shape, dtype=torch.float32, big=0.1, huge=0.05):
    """Non-monotone dyadic rows with BIG and 2e18 (above BIG) mixed in."""
    x = rng.integers(0, 4000, size=shape) / 8.0
    x[rng.random(shape) < big] = BIG
    x[rng.random(shape) < huge] = 2e18
    return torch.as_tensor(x, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [1, 2, 5, 17, 65])
@pytest.mark.parametrize("r", [1, 2, 3, 127])
def test_identity_steps_equal_repeated_minplus(dtype, K, r):
    rng = np.random.default_rng(K * 1000 + r)
    rows = torch.cat([_rows(rng, (40, K), dtype),
                      _rows(rng, (10, K), dtype, big=0.3, huge=0.7),
                      torch.full((2, K), 2e18, dtype=dtype),
                      torch.full((1, K), BIG, dtype=dtype),
                      -torch.zeros((1, K), dtype=dtype)])
    want = rows
    zeros = torch.zeros_like(rows)
    for _ in range(r):
        want = minplus_fused(want, zeros)
    got = identity_steps(rows, r)
    assert torch.equal(got.view(torch.int32 if dtype == torch.float32
                                else torch.int64),
                       want.view(torch.int32 if dtype == torch.float32
                                 else torch.int64))


# -- the kernels' schedule, spelled in torch ---------------------------------

IN_FLIGHT = 1 << 20          # kThreadsInFlight in minplus.cuh


def lane_group(K: int, chains: int, in_flight: int = IN_FLIGHT) -> int:
    """``soar_lane_group``: pow2ceil(min(K, 32)) lanes, halved while the
    launch would run more than ``in_flight`` threads."""
    g = 1
    while g < K and g < 32:
        g <<= 1
    while g > 1 and chains * g > in_flight:
        g >>= 1
    return g


def _minplus_at(acc, child, i):
    """Outputs i (a lane vector) of minplus(acc, child): the candidate set
    of ``minplus_at`` in minplus.cuh, BIG shifted in for j > i."""
    K = acc.shape[0]
    src = i[:, None] - torch.arange(K)[None, :]
    a = torch.where(src >= 0, acc[src.clamp(min=0)], acc.new_tensor(BIG))
    return (a + child[None, :]).amin(dim=1)


def _prefix_min(v):
    """Shuffle-up scan over a group's lanes (``group_prefix_min``)."""
    g, s = v.shape[0], 1
    while s < g:
        u = torch.cat([v[:s], v[:-s]])
        v = torch.where(torch.arange(g) >= s, torch.minimum(v, u), v)
        s <<= 1
    return v


class Group:
    """One lane group's chain work, counting what it runs."""

    def __init__(self, g: int):
        self.g, self.steps, self.scans = g, 0, 0

    def step(self, acc, child, dst):
        """``group_minplus_step``: top chunk first, every lane of a chunk
        reading before any writes (in place when dst is acc)."""
        K, g = acc.shape[0], self.g
        self.steps += 1
        for base in range(((K - 1) // g) * g, -1, -g):
            i = torch.arange(base, min(base + g, K))
            dst[i] = _minplus_at(acc, child, i)

    def identity(self, src, dst, r):
        """``group_identity_steps``: chunks bottom up, the scan's carry
        from the chunk below."""
        K, g = src.shape[0], self.g
        self.scans += 1
        cap_last = r >= 2 and K >= 2
        carry = src.new_tensor(INF)
        for base in range(0, K, g):
            i = base + torch.arange(g)
            live = i < K
            v = torch.where(live, src[i.clamp(max=K - 1)] + 0.0, INF)
            v = torch.minimum(_prefix_min(v), carry)
            carry = v[g - 1]
            v = torch.where((i < K - 1) | cap_last,
                            torch.minimum(v, v.new_tensor(BIG)), v)
            dst[i[live]] = v[live]


def _compact(kw, sentinel, width, start):
    """Ballot compaction in chunks of ``width`` lanes: positions m >= start
    whose child is real, and their indices, in position order."""
    max_c = kw.shape[0]
    pos, cid = [], []
    for base in range(start, max_c, width):
        m = torch.arange(base, base + width)
        c = torch.where(m < max_c, kw[m.clamp(max=max_c - 1)], sentinel)
        real = c != sentinel
        pos += m[real].tolist()
        cid += c[real].tolist()
    return pos, cid


def levelfold_geometry(B, W, K, nl, max_c, elt, in_flight=IN_FLIGHT):
    """``launch_levelfold``'s lane group, nodes a block and threads: as
    many nodes as fill 512 threads, the block halved while its shared
    memory (accumulators, rings of 4 rows, child lists) passes 96 KiB."""
    rows = nl + 1
    g = lane_group(K, B * W * rows, in_flight)
    per_node = rows * g
    cap = 512
    while True:
        nt = 1 if per_node >= cap else min(cap // per_node, W)
        threads = cap if per_node >= cap else (nt * per_node + 31) // 32 * 32
        smem = ((nt * rows * K + threads // g * 4 * K) * elt
                + nt * (2 + 2 * max_c) * 4)
        if smem <= 96 * 1024 or cap <= 32:
            return g, nt, threads
        cap //= 2


def level_fold_lane_groups(xs, xb, kid, load, send, avail, rho, *, nl, kcap,
                           in_flight=IN_FLIGHT):
    """The level-fold kernel's schedule. Returns the output and the K*K
    steps and closed-form scans that the chains ran."""
    B, C = xs.shape[:2]
    W, max_c = kid.shape[1:]
    K, rows = kcap, nl + 1
    g, nt, threads = levelfold_geometry(B, W, K, nl, max_c,
                                        xs.element_size(), in_flight)
    slots = threads // g
    out = torch.full((B, W, nl, K), float("nan"), dtype=xs.dtype)
    grp = Group(g)
    for b in range(B):
        for w0 in range(0, W, nt):
            # phase 0: a warp per node compacts its real children, m >= 1
            lists = {n: (int(kid[b, w0 + n, 0]),
                         *_compact(kid[b, w0 + n], C - 1, 32, 1))
                     for n in range(nt) if w0 + n < W}
            accs = {}
            # phase 1: group `slot` takes chains slot, slot + slots, ...
            for slot in range(slots):
                for p in range(slot, nt * rows, slots):
                    n, r = divmod(p, rows)
                    if w0 + n >= W:
                        continue
                    first, pos, cid = lists[n]
                    row = ((lambda c: xs[b, c, r]) if r < nl
                           else (lambda c: xb[b, c]))
                    acc = row(first).clone()
                    prev = 0
                    for m, c in zip(pos, cid):
                        if m - prev > 1:
                            grp.identity(acc, acc, m - prev - 1)
                        grp.step(acc, row(c), acc)
                        prev = m
                    if max_c - 1 > prev:
                        grp.identity(acc, acc, max_c - 1 - prev)
                    accs[p] = acc
            # phase 2: a group per (node, red row): epilogue and cummin
            for slot in range(slots):
                for p in range(slot, nt * nl, slots):
                    n, r = divmod(p, nl)
                    w = w0 + n
                    if w >= W:
                        continue
                    ar, ab = accs[n * rows + r], accs[n * rows + nl]
                    rr = rho[b, w, r]
                    lr, sr = load[b, w] * rr, send[b, w] * rr
                    carry = xs.new_tensor(INF)
                    for base in range(0, K, g):
                        i = base + torch.arange(g)
                        live = i < K
                        ic = i.clamp(max=K - 1)
                        red = ar[ic] + lr
                        blue = torch.where(avail[b, w] & (i > 0),
                                           ab[(ic - 1).clamp(min=0)] + sr,
                                           BIG)
                        v = torch.where(live, torch.minimum(red, blue), INF)
                        v = torch.minimum(_prefix_min(v), carry)
                        carry = v[g - 1]
                        out[b, w, r, i[live]] = v[live]
    return out, grp.steps, grp.scans


def color_level_lane_groups(ch, kid, i, el, rl, load, send, avail, *, kc,
                            in_flight=IN_FLIGHT, budget=96 * 1024):
    """The color-level kernel's schedule (``color_level_kernel``). Returns
    isblue, split and the K*K steps and scans its chains ran."""
    B, W1, nl1, ldk = ch.shape
    Wi, max_c = kid.shape[1:]
    g = lane_group(kc, 2 * B * Wi, in_flight)
    slab = 4 * max_c * kc * ch.element_size()      # in shared memory
    fit = budget // slab if slab <= budget else 256
    nt = min(256 // (2 * g), fit, Wi)
    isblue = torch.zeros((B, Wi), dtype=torch.bool)
    split = torch.full((B, Wi, max_c), -1, dtype=torch.int64)
    grp = Group(g)
    flat_rows = ch.reshape(B, W1 * nl1, ldk)
    for b in range(B):
        for w0 in range(0, Wi, nt):
            slabs = {}
            for n in range(min(nt, Wi - w0)):        # both chains of node n
                w = w0 + n
                kw = kid[b, w]
                pos, _ = _compact(kw, W1, g, 0)
                last = max(pos, default=0)
                lp = min(last + 2, max_c - 1)
                for chain, row in ((0, int(el[b, w]) + 1), (1, 1)):
                    xc = torch.zeros((max_c, kc), dtype=ch.dtype)
                    for m in range(lp + 1):
                        flat = int(kw[m]) * nl1 + row
                        if flat < W1 * nl1:
                            xc[m] = flat_rows[b, flat, :kc]
                    part = torch.zeros((max_c, kc), dtype=ch.dtype)
                    part[0] = xc[0]
                    for m in range(1, lp + 1):
                        if int(kw[m]) != W1:
                            grp.step(part[m - 1], xc[m], part[m])
                        else:
                            grp.identity(part[m - 1], part[m], 1)
                    slabs[n, chain] = (part, xc, lp)
            for n in range(min(nt, Wi - w0)):        # after the barrier
                w = w0 + n
                (fr, _, lp), (fb, _, _) = slabs[n, 0], slabs[n, 1]
                ii = int(i[b, w])
                ic, ib = min(ii, kc - 1), min(max(ii - 1, 0), kc - 1)
                red_val = fr[lp, ic] + load[b, w] * rl[b, w]
                blue_val = (fb[lp, ib] + send[b, w] * rl[b, w]
                            if bool(avail[b, w]) and ii >= 1 else INF)
                blue = bool(blue_val < red_val)
                part, xc, _ = slabs[n, int(blue)]
                isblue[b, w] = blue
                split[b, w, lp + 1 :] = 0
                bud = ii - int(blue)
                for m in range(lp, 0, -1):
                    # each lane's first minimizer over j = q, q + g, ...
                    bv = torch.full((g,), INF, dtype=ch.dtype)
                    bj = torch.full((g,), 2 ** 31 - 1)
                    for q in range(g):
                        for j in range(q, kc, g):
                            v = (part[m - 1, min(bud - j, kc - 1)] + xc[m, j]
                                 if j <= bud else part.new_tensor(INF))
                            if bj[q] == 2 ** 31 - 1 or v < bv[q]:
                                bv[q], bj[q] = v, j
                    s = g >> 1                       # butterfly argmin
                    while s:
                        o = torch.arange(g) ^ s
                        take = (bv[o] < bv) | ((bv[o] == bv) & (bj[o] < bj))
                        bv = torch.where(take, bv[o], bv)
                        bj = torch.where(take, bj[o], bj)
                        s >>= 1
                    split[b, w, m] = bj[0]
                    bud -= int(bj[0])
                split[b, w, 0] = bud
    return isblue, split, grp.steps, grp.scans


# -- the forests and their recorded level calls ------------------------------

def _hub(seed):
    """A tree whose root has 70 children (max_children buckets to 128),
    each with 0-3 children of its own; rates in 1/8 steps."""
    rng = np.random.default_rng(seed)
    parent = [-1] + [0] * 70
    for v in range(1, 71):
        parent += [v] * int(rng.integers(0, 4))
    n = len(parent)
    rho = np.maximum(np.round(rng.random(n) * 16), 1) / 8
    return tcore.Tree(np.array(parent, np.int32), rho)


def _forests():
    rng = np.random.default_rng(0)
    hub = [_hub(s) for s in range(2)]
    hub_loads = [rng.integers(0, 7, size=t.n) for t in hub]
    hub_avail = [rng.random(t.n) < 0.8 for t in hub]
    t = tcore.bt(64, "exponential")
    return {"hub128": (hub, hub_loads, hub_avail, 6),
            "bt64": ([t] * 2, [tcore.sample_load(t, "power-law", seed=s)
                               for s in range(2)], None, 9)}


FORESTS = _forests()


def _record(name, dtype):
    """Solve one forest on the CPU, recording every level-fold and
    color-level call the engine makes."""
    trees, loads, avail, k = FORESTS[name]
    folds, colors = [], []
    fold0, color0 = batched.level_fold, batched.color_level

    def rec_fold(*a, **kw):
        folds.append((a, kw))
        return fold0(*a, **kw)

    def rec_color(*a, **kw):
        colors.append((a, kw))
        return color0(*a, **kw)

    batched.level_fold, batched.color_level = rec_fold, rec_color
    try:
        solve_batch(trees, loads, k, avail, options=CPU.replace(dtype=dtype))
    finally:
        batched.level_fold, batched.color_level = fold0, color0
    return tcore.build_forest(trees, loads, avail), folds, colors


# threads in flight: the card's 2^20 (full groups at these sizes), and 8,
# which narrows every group to one lane, each owning all K outputs
FLIGHTS = [IN_FLIGHT, 8]


@pytest.mark.parametrize("in_flight", FLIGHTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["hub128", "bt64"])
def test_level_fold_schedule_on_forest_levels(name, dtype, in_flight):
    f, folds, _ = _record(name, dtype)
    assert f.max_children == {"hub128": 128, "bt64": 2}[name]
    assert folds
    for a, kw in folds:
        got, steps, scans = level_fold_lane_groups(*a, **kw,
                                                   in_flight=in_flight)
        assert torch.equal(got, level_fold_torch(*a, **kw))
        # one K*K step per real child after the first, per chain: none for
        # a sentinel, and one closed-form scan per run of them at most
        kid, C = a[2], a[0].shape[1]
        real_after_first = int((kid[:, :, 1:] != C - 1).sum())
        assert steps == real_after_first * (kw["nl"] + 1)
        assert scans <= kid.shape[0] * kid.shape[1] * (kw["nl"] + 1)
    if dtype == torch.float32:    # the JAX level fold on the same inputs
        for a, kw in folds:
            j = [jnp.asarray(t.numpy()) for t in a]
            j[2] = j[2].astype(jnp.int32)
            assert np.array_equal(level_fold_torch(*a, **kw).numpy(),
                                  np.asarray(jlf.level_fold_jnp(*j, **kw)))


@pytest.mark.parametrize("in_flight", FLIGHTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["hub128", "bt64"])
def test_color_level_schedule_on_forest_levels(name, dtype, in_flight):
    _, _, colors = _record(name, dtype)
    assert colors
    for a, kw in colors:
        isblue, split, steps, _ = color_level_lane_groups(
            *a, **kw, in_flight=in_flight)
        want_blue, want_split = color_level_torch(*a, **kw)
        assert torch.equal(isblue, want_blue)
        assert torch.equal(split, want_split)
        # two chains a node, one K*K step per real child after the first
        kid, W1 = a[1], a[0].shape[1]
        assert steps == 2 * int((kid[:, :, 1:] != W1).sum())


def _random_fold_level(seed, B, C, W, max_c, nl, K, dtype, huge):
    rng = np.random.default_rng(seed)
    xs = _rows(rng, (B, C, nl, K), dtype, huge=huge)
    xb = _rows(rng, (B, C, K), dtype, huge=huge)
    xs[:, -1] = 0
    xb[:, -1] = 0
    kid = rng.integers(0, C - 1, size=(B, W, max_c))
    kid[rng.random(kid.shape) < 0.5] = C - 1      # interleaved sentinels
    kid[:, :, max_c // 2 :] = C - 1               # and a trailing run
    load = torch.as_tensor(rng.integers(0, 30, (B, W)), dtype=dtype)
    send = torch.as_tensor(rng.integers(0, 2, (B, W)), dtype=dtype)
    avail = torch.as_tensor(rng.random((B, W)) < 0.7)
    rho = torch.as_tensor(1.0 / rng.integers(1, 12, (B, W, nl)), dtype=dtype)
    return (xs, xb, torch.as_tensor(kid), load, send, avail, rho), dict(
        nl=nl, kcap=K)


@pytest.mark.parametrize("in_flight", FLIGHTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("huge", [0.05, 0.85])
@pytest.mark.parametrize("B,C,W,max_c,nl,K", [
    (2, 7, 3, 9, 2, 2), (1, 12, 40, 5, 12, 5), (1, 9, 2, 6, 33, 40)])
def test_level_fold_schedule_on_random_rows(B, C, W, max_c, nl, K, huge,
                                            dtype, in_flight):
    a, kw = _random_fold_level(B * 7 + W, B, C, W, max_c, nl, K, dtype, huge)
    got, _, _ = level_fold_lane_groups(*a, **kw, in_flight=in_flight)
    assert torch.equal(got, level_fold_torch(*a, **kw))


@pytest.mark.parametrize("in_flight", FLIGHTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("huge", [0.05, 0.85])
@pytest.mark.parametrize("B,W1,nl1,ldk,Wi,max_c,kc", [
    (2, 7, 3, 3, 3, 12, 2), (1, 12, 12, 6, 20, 5, 5),
    (1, 9, 5, 40, 3, 6, 33)])
def test_color_level_schedule_on_random_rows(B, W1, nl1, ldk, Wi, max_c, kc,
                                             huge, dtype, in_flight):
    rng = np.random.default_rng(B * 11 + Wi)
    ch = _rows(rng, (B, W1, nl1, ldk), dtype, huge=huge)
    kid = rng.integers(0, W1, size=(B, Wi, max_c))
    kid[rng.random(kid.shape) < 0.4] = W1
    kid[:, :, max_c // 2 :] = W1
    a = (ch, torch.as_tensor(kid),
         torch.as_tensor(rng.integers(0, ldk + 2, (B, Wi))),
         torch.as_tensor(rng.integers(0, nl1 - 1, (B, Wi))),
         torch.as_tensor(1.0 / rng.integers(1, 12, (B, Wi)), dtype=dtype),
         torch.as_tensor(rng.integers(0, 30, (B, Wi)), dtype=dtype),
         torch.as_tensor(rng.integers(0, 30, (B, Wi)), dtype=dtype),
         torch.as_tensor(rng.random((B, Wi)) < 0.7))
    isblue, split, _, _ = color_level_lane_groups(*a, kc=kc,
                                                  in_flight=in_flight)
    want_blue, want_split = color_level_torch(*a, kc=kc)
    assert torch.equal(isblue, want_blue)
    assert torch.equal(split, want_split)


# -- the whole solve on forests with a hub -----------------------------------

@pytest.mark.parametrize("k", [4, 16])
def test_rpa_hub_solve_equals_jax_and_serial(k):
    """4 x rpa(256) with availability (seeds 8-11: hubs of 36 and 41
    children, so max_children buckets to 64, above every level's real
    child count); masks and costs bitwise equal to the JAX engine and the
    float64 serial soar."""
    jt = [jcore.rpa(256, seed=s) for s in range(8, 12)]
    tt = [tcore.rpa(256, seed=s) for s in range(8, 12)]
    loads = [tcore.sample_load(t, "power-law", seed=s)
             for s, t in enumerate(tt)]
    rng = np.random.default_rng(k)
    avails = [rng.random(t.n) < 0.8 for t in tt]
    f = tcore.build_forest(tt, loads, avails)
    real = [int((f.pk_kid[:, o : o + wi] < f.n_slots).sum(2).max())
            for o, wi in zip(f.lvl_off, f.lvl_internal) if wi]
    assert max(real) < f.max_children
    got = solve_batch(tt, loads, k, avails, options=CPU)
    want = j_solve_batch(jt, loads, k, avails)
    assert np.array_equal(got.costs, want.costs)
    assert np.array_equal(got.blue, want.blue)
    for b, t in enumerate(tt):
        ref = tcore.soar(t, loads[b], k, avail=avails[b])
        assert got.costs[b] == ref.cost
        assert np.array_equal(got.blue_of(b), ref.blue)


def test_color_level_wrapper_rejects_cpu_tensors():
    """The color-level wrapper launches its kernel or raises; it never
    computes on the host (the dispatcher owns the CPU path)."""
    from repro_torch.kernels.minplus.minplus import color_level_cuda
    _, _, colors = _record("bt64", torch.float32)
    a, kw = colors[0]
    with pytest.raises(ValueError, match="CUDA"):
        color_level_cuda(*a, **kw)
