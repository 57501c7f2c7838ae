"""CUDA kernels vs their plain torch versions, on the card.

Marked ``cuda``: skipped where no card is present (decided in a fixture,
so every xdist worker collects the same tests). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every comparison of the solve, reduce and top-k kernels is bitwise
(``torch.equal``): they keep the plain versions' candidate sets, child
order, summation order and separate roundings (no FMA). Flash attention is
held to the JAX tests' tolerances (float32 rtol = atol = 2e-5, bfloat16
3e-2): it sums in another order and uses FMA. In bfloat16 each kernel is
also held to the plain version in float32 on the same inputs: the
CUDA-core tile kernel and the split decode, which keep the softmax weights
in float32, within 2^-8 |want| + 2^-15 (``FLASH_TIGHT``); the tensor-core
tile kernel, which rounds them to bfloat16 for P.V, within 2^-8 |want| +
(2^-8 + 2^-15) A + 2^-15, A the float32 plain attention over |v|
(``FLASH_TC``; both derived in ``chip_smoke.py``). The selective-SSM scan
is held to the JAX test's rtol = atol = 1e-5 (its sum over N runs in
another order, its exponential is ex2.approx of a pre-scaled argument), and
at a longer sequence to the float64 plain version within the error bound
derived for it (``chip_smoke.scan_f64_bound``); its backward to the
float64 plain backward within ``chip_smoke.SCAN_BWD_REL`` of the backward
on absolute values. Reduced hymba and xLSTM train on the card as on the
CPU, with the scan's launches counted.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Tree, build_forest
from repro_torch.core.tropical import BIG
from repro_torch.engine import EngineOptions, solve_batch, solve_forest
from repro_torch.kernels.minplus import minplus as minplus_mod
from repro_torch.kernels.minplus.color import color_level, color_level_torch
from repro_torch.kernels.minplus.levelfold import (level_fold,
                                                   level_fold_cuda,
                                                   level_fold_torch,
                                                   minplus_fused)
from repro_torch.kernels.minplus.minplus import color_level_cuda, minplus_cuda
from repro_torch.kernels.minplus.ops import minplus
from repro_torch.kernels.segment_reduce.ops import reduce_table, segment_reduce
from repro_torch.kernels.segment_reduce.ref import segment_reduce_torch
from repro_torch.kernels.segment_reduce.segment_reduce import (
    segment_reduce_cuda, tile_of)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rows(rng, shape, dtype, dev, big_frac=0.2):
    x = rng.integers(0, 4000, size=shape) / 8.0
    x[rng.random(shape) < big_frac] = BIG
    return torch.as_tensor(x, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,k", [(1, 1), (7, 2), (300, 17), (33, 33),
                                    (64, 65), (9, 129), (3, 300)])
def test_minplus_kernel_bitwise(dev, dtype, rows, k):
    rng = np.random.default_rng(rows * 7 + k)
    a, b = _rows(rng, (rows, k), dtype, dev), _rows(rng, (rows, k), dtype, dev)
    before = minplus_cuda.launches
    got = minplus(a, b)
    assert minplus_cuda.launches == before + 1
    assert torch.equal(got, minplus_fused(a, b))


def _saturate(x, rng, frac):
    """Set a fraction of x's entries to 2e18, above BIG (BIG + BIG)."""
    if frac:
        x[torch.as_tensor(rng.random(tuple(x.shape)) < frac,
                          device=x.device)] = 2e18
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("huge", [0.0, 0.85])
@pytest.mark.parametrize("B,C,W,max_c,nl,kcap", [
    (1, 2, 1, 1, 2, 1), (2, 5, 3, 2, 3, 4), (3, 40, 37, 4, 5, 9),
    (2, 17, 8, 8, 14, 65), (1, 9, 5, 3, 33, 129), (2, 30, 6, 128, 3, 17),
    (1, 12, 300, 2, 12, 5),
    (1, 12, 40000, 2, 12, 5)])   # 520,000 chains: groups narrow to 2 lanes
def test_level_fold_kernel_bitwise(dev, dtype, huge, B, C, W, max_c, nl,
                                   kcap):
    rng = np.random.default_rng(B * 100 + C * 10 + max_c)
    xs = _saturate(_rows(rng, (B, C, nl, kcap), dtype, dev, 0.05), rng, huge)
    xb = _saturate(_rows(rng, (B, C, kcap), dtype, dev, 0.05), rng, huge)
    xs[:, -1] = 0
    xb[:, -1] = 0
    kid = rng.integers(0, C, size=(B, W, max_c))
    kid[rng.random(kid.shape) < 0.3] = C - 1   # interleaved sentinels
    kid[:, :, (max_c + 1) // 2 :][rng.random((B, W)) < 0.5] = C - 1
    kid = torch.as_tensor(kid, device=dev)
    load = torch.as_tensor(rng.integers(0, 30, (B, W)), dtype=dtype,
                           device=dev)
    send = torch.as_tensor(rng.integers(0, 2, (B, W)), dtype=dtype,
                           device=dev)
    avail = torch.as_tensor(rng.random((B, W)) < 0.7, device=dev)
    # linear-style rates: an FMA would change the last bit here
    rho = torch.as_tensor(1.0 / rng.integers(1, 12, (B, W, nl)),
                          dtype=dtype, device=dev)
    args = (xs, xb, kid, load, send, avail, rho)
    before = level_fold_cuda.launches
    got = level_fold(*args, nl=nl, kcap=kcap)
    assert level_fold_cuda.launches == before + 1
    assert torch.equal(got, level_fold_torch(*args, nl=nl, kcap=kcap))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("huge", [0.0, 0.85])
@pytest.mark.parametrize("scratch", [False, True])
@pytest.mark.parametrize("B,W1,nl1,ldk,Wi,max_c,kc", [
    (1, 1, 2, 1, 1, 1, 1), (2, 5, 3, 4, 3, 2, 4), (3, 40, 5, 9, 37, 4, 9),
    (2, 17, 14, 65, 8, 8, 65), (1, 9, 33, 129, 5, 3, 100),
    (2, 30, 3, 17, 6, 128, 17), (1, 12, 12, 6, 300, 2, 5),
    (2, 50, 3, 5, 40000, 2, 5)])   # 160,000 chains: groups narrow to 4
def test_color_level_kernel_bitwise(dev, dtype, huge, scratch, B, W1, nl1,
                                    ldk, Wi, max_c, kc, monkeypatch):
    """Random rows (non-monotone, BIG, 2e18) and sentinels both
    interleaved and trailing: the kernel skips split steps only where the
    closed form proves j = 0, so it is bitwise on any input; ``scratch``
    forces the node slabs out of shared memory."""
    if scratch:
        monkeypatch.setattr(minplus_mod, "COLOR_SMEM_BUDGET", 0)
    rng = np.random.default_rng(B * 100 + W1 * 10 + max_c)
    ch = _saturate(_rows(rng, (B, W1, nl1, ldk), dtype, dev, 0.1), rng, huge)
    kid = rng.integers(0, W1, size=(B, Wi, max_c))
    kid[rng.random(kid.shape) < 0.3] = W1
    kid[:, :, (max_c + 1) // 2 :][rng.random((B, Wi)) < 0.5] = W1
    ints = lambda hi: torch.as_tensor(rng.integers(0, hi, (B, Wi)),
                                      device=dev)
    vals = lambda hi: torch.as_tensor(rng.integers(0, hi, (B, Wi)),
                                      dtype=dtype, device=dev)
    args = (ch, torch.as_tensor(kid, device=dev), ints(ldk + 2),
            ints(nl1 - 1),
            torch.as_tensor(1.0 / rng.integers(1, 12, (B, Wi)), dtype=dtype,
                            device=dev),
            vals(30), vals(30),
            torch.as_tensor(rng.random((B, Wi)) < 0.7, device=dev))
    before = color_level_cuda.launches
    isblue, split = color_level(*args, kc=kc)
    assert color_level_cuda.launches == before + 1
    want_blue, want_split = color_level_torch(*args, kc=kc)
    assert torch.equal(isblue, want_blue)
    assert torch.equal(split, want_split)


def _ragged(seed, B, n_hi=40):
    rng = np.random.default_rng(seed)
    trees, loads, avails = [], [], []
    for _ in range(B):
        n = int(rng.integers(1, n_hi + 1))
        parent = np.full(n, -1, np.int32)
        for v in range(1, n):
            parent[v] = int(rng.integers(0, v))
        trees.append(Tree(parent, 1.0 / rng.integers(1, 9, size=n)))
        loads.append(rng.integers(0, 7, size=n))
        avails.append(rng.random(n) < 0.7)
    return trees, loads, avails


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed,k,cap", [(0, 0, True), (1, 3, True),
                                        (2, 9, False)])
def test_solve_on_card_equals_cpu(dev, dtype, seed, k, cap):
    trees, loads, avails = _ragged(seed, 12)
    opts = EngineOptions(dtype=dtype, cap=cap)
    folds, colors = level_fold_cuda.launches, color_level_cuda.launches
    chains = minplus_cuda.launches
    got = solve_batch(trees, loads, k, avails, options=opts)
    assert level_fold_cuda.launches > folds
    assert color_level_cuda.launches > colors
    assert minplus_cuda.launches == chains     # not on the solve's path
    want = solve_batch(trees, loads, k, avails,
                       options=opts.replace(device="cpu"))
    assert np.array_equal(got.costs, want.costs)
    assert np.array_equal(got.blue, want.blue)
    f = build_forest(trees, loads, avails)
    scale = np.random.default_rng(seed).integers(1, 9, (f.batch, f.n_max)) / 4
    extra = np.arange(f.batch) / 8.0
    a = solve_forest(f, k, options=opts, rho_scale=scale, rho_root_add=extra)
    b = solve_forest(f, k, options=opts.replace(device="cpu"),
                     rho_scale=scale, rho_root_add=extra)
    assert np.array_equal(a.costs, b.costs)
    assert np.array_equal(a.blue, b.blue)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,c,d", [(1, 1, 8), (4, 7, 130), (16, 32, 512),
                                   (3, 5, 1000), (2, 300, 9), (5, 3, 4097)])
def test_segment_reduce_kernel_bitwise(dev, dtype, g, c, d):
    rng = np.random.default_rng(g * 100 + c)
    x = torch.as_tensor(rng.normal(size=(g, c, d)), dtype=dtype, device=dev)
    mask = torch.as_tensor(rng.random((g, c)) < 0.7, device=dev)
    before = segment_reduce_cuda.launches
    got = segment_reduce(x, mask)
    assert segment_reduce_cuda.launches == before + 1
    assert torch.equal(got, segment_reduce_torch(x, mask))
    # a misaligned start takes the scalar loads
    big = torch.empty(g * c * d + 1, dtype=dtype, device=dev)
    big[1:] = x.reshape(-1)
    assert torch.equal(segment_reduce(big[1:].view(g, c, d), mask), got)


def test_segment_reduce_rows_in_place(dev):
    """The table form writing over rows of a scratch it also reads: the
    rows named are written, the rest stay."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(6, 1028)), dtype=torch.float32,
                        device=dev)
    scratch = torch.as_tensor(rng.normal(size=(40, 1028)),
                              dtype=torch.float32, device=dev)
    table = torch.as_tensor([[0, 6, 7, -1, 2], [10, 10, 5, 1, -1],
                             [45, -1, -1, -1, -1]], device=dev)
    rows = torch.tensor([39, 0, 20], device=dev)
    want = segment_reduce_torch(x, None, table, scratch=scratch,
                                round_each=True)
    assert torch.equal(reduce_table(x, table, scratch=scratch), want)
    out = scratch.clone()
    reduce_table(x, table, scratch=out, out=out, out_rows=rows)
    expect = scratch.clone()
    expect[rows] = want
    assert torch.equal(out, expect)


def _sr_case(rng, g, c, r0, p, d, dtype, dev):
    x, s = (torch.as_tensor(rng.standard_normal((n, d))
                            * np.exp(2 * rng.standard_normal((n, d))),
                            dtype=dtype, device=dev) for n in (r0, p))
    table = torch.as_tensor(rng.integers(-1, r0 + p, size=(g, c)),
                            device=dev)
    table[0, : min(c, 3)] = r0 + p - 1
    return x, s, table


@pytest.mark.parametrize("round_each", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,c,r0,p,d", [
    (1, 5, 3, 4, 1_000_003), (2, 9, 4, 6, 262_144), (3, 300, 7, 9, 4097),
    (4096, 8, 100, 50, 40), (60_000, 3, 10, 10, 16), (7, 17, 64, 17, 6)])
def test_segment_reduce_table_kernel_bitwise(dev, dtype, round_each, g, c,
                                             r0, p, d):
    """Random tables over x and scratch rows (repeats, -1 entries, weights
    of 0), small-G/large-D and large-G/small-D grids, misaligned D and a
    misaligned x: the kernel equals the plain version bitwise, writes only
    the rows named, and counts one launch."""
    rng = np.random.default_rng(g + c + d)
    x, s, table = _sr_case(rng, g, c, r0, p, d, dtype, dev)
    mask = torch.as_tensor(rng.random((g, c)) < 0.9, device=dev)
    q = g + 5
    out_rows = torch.as_tensor(rng.permutation(q)[:g], device=dev)
    want = segment_reduce_torch(x, mask, table, scratch=s,
                                round_each=round_each)
    for shift in (0, 1):            # 1: x starts off a 16-byte boundary
        big = torch.empty(r0 * d + shift, dtype=dtype, device=dev)
        big[shift:] = x.reshape(-1)
        xs = big[shift:].view(r0, d)
        out = torch.full((q, d), 7.0, dtype=dtype, device=dev)
        before = segment_reduce_cuda.launches
        segment_reduce_cuda(xs, mask, table, scratch=s, out=out,
                            out_rows=out_rows, round_each=round_each)
        assert segment_reduce_cuda.launches == before + 1
        assert torch.equal(out[out_rows], want)
        kept = torch.ones(q, dtype=torch.bool, device=dev)
        kept[out_rows] = False
        assert bool((out[kept] == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(1, 65_536), (4, 65_536), (1, 300),
                                 (2, 6_553_600)])
def test_segment_reduce_narrowed_tiles_bitwise(dev, dtype, g, d):
    """Grids the launcher narrows (tile 256 and 512) and one it does not."""
    rng = np.random.default_rng(g * d)
    x, s, table = _sr_case(rng, g, 12, 8, 4, d, dtype, dev)
    assert tile_of(g, d, dtype) in (256, 512, 1024, 2048)
    got = reduce_table(x, table, scratch=s)
    assert torch.equal(got, segment_reduce_torch(x, None, table, scratch=s,
                                                 round_each=True))


def test_executor_on_card_equals_cpu(dev):
    import repro_torch.collectives as T
    from repro_torch.collectives.tree_allreduce import device_program
    rng = np.random.default_rng(1)
    n = 0
    for dims in [(1, 2, 2), (2, 2, 2), (2, 2, 4), (2, 4, 8)]:
        topo = T.chip_level_tree(*dims)
        t = topo.tree
        x = torch.as_tensor(rng.standard_normal((topo.n_devices, 4099)),
                            dtype=torch.float32)
        for _ in range(6):
            blue = rng.random(t.n) < 0.5
            scales = {int(s): 0.5 for s in rng.choice(t.n, 2, replace=False)}
            for tp in (topo, T.degrade_switches(topo, scales)):
                prog = T.build_program(tp, blue)
                before = segment_reduce_cuda.launches
                got = T.tree_allreduce(x.to(dev), prog)
                assert (segment_reduce_cuda.launches - before
                        == device_program(prog, dev).n_reduce)
                assert torch.equal(got.cpu(), T.tree_allreduce(x, prog))
                n += 1
    assert n == 48


# -- the training path: top-k, bfloat16 reduce, the trainer -------------------

def _topk_rows(rng, r, d):
    x = rng.standard_normal((r, d))
    x[0, rng.choice(d, min(d, 5), replace=False)] = np.inf
    if r > 1:
        x[1] = rng.integers(-3, 4, size=d)           # heavy ties
    if r > 2:
        x[2] = 0.0
        x[2, :2] = [-0.0, 1.0]                        # fewer than k nonzeros
    if r > 3:
        x[3, rng.choice(d, 2, replace=False)] = np.nan
    return x


def _raw(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d,k", [(1, 16, 4), (8, 256, 32), (5, 100, 10),
                                   (4, 5120, 51), (2, 300_001, 3_000),
                                   (4, 64, 64)])
def test_topk_kernel_bitwise(dev, dtype, r, d, k):
    from repro_torch.kernels.topk_compress.ops import (topk_compress,
                                                       topk_threshold)
    from repro_torch.kernels.topk_compress.ref import (topk_compress_torch,
                                                       topk_threshold_torch)
    from repro_torch.kernels.topk_compress.topk_compress import (
        topk_compress_cuda, topk_threshold_cuda)
    x = torch.as_tensor(_topk_rows(np.random.default_rng(d + k), r, d),
                        device=dev).to(dtype)
    before = (topk_compress_cuda.launches, topk_threshold_cuda.launches)
    v, i = topk_compress(x, k)
    t = topk_threshold(x, k)
    assert (topk_compress_cuda.launches, topk_threshold_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    wv, wi = topk_compress_torch(x, k)
    assert torch.equal(i, wi)
    assert torch.equal(_raw(v), _raw(wv))
    wt = topk_threshold_torch(x, k)
    nan = torch.isnan(wt)
    assert torch.equal(torch.isnan(t), nan)
    assert torch.equal(_raw(t[~nan]), _raw(wt[~nan]))
    srt = torch.sort(i.long(), dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())


@pytest.mark.parametrize("g,c,d", [(1, 2, 4099), (3, 8, 1024), (2, 64, 9)])
def test_segment_reduce_round_each_kernel_bitwise(dev, g, c, d):
    """Rounding after each add differs from rounding once wherever a group
    folds three or more rows (0 + x is exact)."""
    rng = np.random.default_rng(g + c + d)
    x = torch.as_tensor(rng.standard_normal((g, c, d))
                        * np.exp(2 * rng.standard_normal((g, c, d))),
                        dtype=torch.bfloat16, device=dev)
    mask = torch.as_tensor(rng.random((g, c)) < 0.8, device=dev)
    got = segment_reduce_cuda(x, mask, round_each=True)
    assert torch.equal(got, segment_reduce_torch(x, mask, round_each=True))
    if int(mask.sum(1).max()) >= 3:
        assert not torch.equal(got, segment_reduce_torch(x, mask))


def test_bf16_executor_on_card_equals_cpu(dev):
    import repro_torch.collectives as T
    rng = np.random.default_rng(4)
    topo = T.chip_level_tree(2, 2, 2)
    x = torch.as_tensor(rng.standard_normal((8, 5000)), dtype=torch.bfloat16)
    for blue in (np.ones(topo.tree.n, bool), rng.random(topo.tree.n) < 0.5):
        for tp in (topo, T.degrade_switches(topo, {1: 0.5})):
            prog = T.build_program(tp, blue)
            got = T.tree_allreduce(x.to(dev), prog)
            assert got.dtype == torch.bfloat16
            assert torch.equal(_raw(got.cpu()), _raw(T.tree_allreduce(x,
                                                                      prog)))


def test_post_gradient_half_on_card_equals_cpu(dev):
    """Compression, the SOAR reduce and the scale on the card equal the CPU
    bit for bit on the same per-worker gradients (bfloat16, 8 workers)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import CompressionConfig, compress_leaf
    rng = np.random.default_rng(8)
    g = torch.as_tensor(rng.standard_normal((8, 3, 40, 24)),
                        dtype=torch.bfloat16)
    ccfg = CompressionConfig.parse("topk:0.05")
    out = {}
    for where in ("cpu", dev):
        prog = train.orchestrator(8, 2, device=where).program
        step = train.make_step(ARCHS["qwen3-32b"].reduced(),
                               adamw.AdamWConfig(), prog, 8 / 7, ccfg)
        ef = torch.zeros(g.shape, device=where)
        sent = torch.empty_like(g, device=where)
        for s in range(2):
            for i in range(8):
                si, resid = compress_leaf(g[i].to(where), ef[i], ccfg)
                ef[i].copy_(resid)
                sent[i].copy_(si)
        out[str(where)] = (sent.cpu(), ef.cpu(),
                           step.reduce({"w": sent.clone()})["w"].cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(_raw(a) if a.is_floating_point() else a,
                           _raw(b) if b.is_floating_point() else b)


def test_trainer_main_on_card(dev, tmp_path):
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels.topk_compress.topk_compress import (
        topk_threshold_cuda)
    from repro_torch.launch import train
    before = (topk_threshold_cuda.launches, segment_reduce_cuda.launches,
              level_fold_cuda.launches)
    args = ["--reduced", "--n-dev", "8", "--global-batch", "8", "--seq",
            "32", "--steps", "5", "--compress", "topk:0.05", "--ckpt-every",
            "3", "--log-every", "1"]
    losses = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(losses) == 5 and np.isfinite(losses).all()
    after = (topk_threshold_cuda.launches, segment_reduce_cuda.launches,
             level_fold_cuda.launches)
    assert all(a > b for a, b in zip(after, before))
    import shutil
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert resumed == losses[3:]
    a = np.load(tmp_path / "a" / "step_00000005" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_00000005" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)
    assert ckpt.latest_step(tmp_path / "a") == 5


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _flash_limit(got, q, k, v, scale, causal, window=0, tc=False):
    """A bfloat16 output against the float32 plain version on the same
    inputs: ``FLASH_TC`` (``tc``, the tensor-core tile kernel) or
    ``FLASH_TIGHT``; returns max |err| / limit."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_gqa_torch)
    f = [x.float() for x in (q, k, v)]
    want = flash_attention_gqa_torch(*f, scale, causal, window)
    lim = 2.0 ** -8 * want.abs() + 2.0 ** -15
    if tc:
        lim += (2.0 ** -8 + 2.0 ** -15) * flash_attention_gqa_torch(
            f[0], f[1], f[2].abs(), scale, causal, window)
    return float(((got.float() - want).abs() / lim).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,s,d,causal", [
    (2, 64, 64, 32, True), (4, 128, 128, 64, True), (1, 200, 200, 128, True),
    (3, 256, 256, 16, True), (2, 128, 128, 32, False),
    (2, 37, 101, 48, False), (2, 130, 61, 40, True), (2, 300, 200, 48, True),
    (1, 5, 300, 200, False), (3, 1, 77, 128, False)])
def test_flash_kernel_matches_plain(dev, dtype, bh, t, s, d, causal):
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda, path_of)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    rng = np.random.default_rng(bh * 31 + t + s)
    q = torch.as_tensor(rng.normal(size=(bh, t, d)), device=dev).to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(bh, s, d)), device=dev).to(dtype)
            for _ in range(2))
    before = flash_attention_cuda.launches
    path = path_of(q[:, :, None])
    by_path = flash_attention_cuda.launches_by_path[path]
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention_cuda.launches == before + 1
    assert flash_attention_cuda.launches_by_path[path] == by_path + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_torch(q, k, v, causal)
    torch.testing.assert_close(got, want, rtol=FLASH_TOL[dtype],
                               atol=FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        # against the float32 plain version on the same inputs: the
        # CUDA-core kernels' float32 arithmetic (2e-5), then the output's
        # rounding to bfloat16 (half an ulp, 2^-8 of the value); the
        # tensor-core kernel also rounds each weight (2^-8 A)
        assert _flash_limit(got[:, :, None], q[:, :, None], k[:, :, None],
                            v[:, :, None], d ** -0.5, causal,
                            tc=path == "tile_tc") <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [128, 36])
def test_flash_kernel_on_decode_prefix_views(dev, dtype, hd):
    """T = 1 over strided cache prefixes (16-byte rows at hd 128, the
    scalar loads at hd 36), and GQA prefill on the model's layout."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_gqa_torch)
    rng = np.random.default_rng(hd)
    cache_k, cache_v = (torch.as_tensor(rng.normal(size=(2, 300, 2, hd)),
                                        device=dev).to(dtype)
                        for _ in range(2))
    q = torch.as_tensor(rng.normal(size=(2, 1, 8, hd)), device=dev).to(dtype)
    tol = FLASH_TOL[dtype]
    for n in (1, 2, 129, 300):
        kp, vp = cache_k[:, :n], cache_v[:, :n]
        torch.testing.assert_close(
            flash_attention_gqa(q, kp, vp, 0.125, causal=False),
            flash_attention_gqa_torch(q, kp, vp, 0.125, causal=False),
            rtol=tol, atol=tol)
    qp = torch.as_tensor(rng.normal(size=(2, 300, 8, hd)),
                         device=dev).to(dtype)
    torch.testing.assert_close(
        flash_attention_gqa(qp, cache_k, cache_v, 0.125, causal=True),
        flash_attention_gqa_torch(qp, cache_k, cache_v, 0.125, causal=True),
        rtol=tol, atol=tol)


def test_serving_on_card_equals_cpu(dev):
    """Reduced qwen3-32b in float32 (TF32 off): prefill and 4 decode steps
    on the card against the CPU, logits at rtol 1e-4 with an atol of 1e-4
    times the largest logit (summation order), and the same tokens."""
    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.launch import steps
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["qwen3-32b"].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    card = T.tree_map(lambda w: w.detach().to(dev), params)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)))
    before = flash_attention_cuda.launches
    out = {}
    for where, p, t in (("cpu", params, toks), ("card", card, toks.to(dev))):
        tok, pre = steps.make_prefill_step(cfg)(p, {"tokens": t})
        caches = api.init_caches(cfg, 2, 16, p["embed_tokens"].device)
        for k in ("k", "v"):
            caches["layers"][k][:, :, :12] = pre["layers"][k]
        toks_out, logits = [tok], []
        for s in range(4):
            with torch.inference_mode():
                lg, caches = api.decode_fn(cfg)(p, caches, tok, 12 + s)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            toks_out.append(tok)
            logits.append(lg)
        out[where] = (torch.cat(toks_out, 1).cpu(),
                      torch.cat(logits, 1).cpu())
    assert flash_attention_cuda.launches == before + 5 * cfg.n_layers
    assert torch.equal(out["card"][0], out["cpu"][0])
    want = out["cpu"][1]
    torch.testing.assert_close(out["card"][1], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,window", [
    (2, 200, 4, 2, 64, 1), (2, 200, 4, 2, 64, 63), (1, 300, 2, 1, 64, 64),
    (2, 333, 5, 1, 64, 100), (1, 130, 2, 2, 40, 1024), (1, 1, 2, 1, 64, 8)])
def test_flash_kernel_sliding_window_matches_plain(dev, dtype, b, t, h, hkv,
                                                   d, window):
    """Windows of 1, 63, 64 and 100 (not multiples of the 64-key tile),
    one longer than T, and T = 1, against ``sdpa`` under
    ``causal_mask(T, T, window)``; the kernel without the window must
    differ where the band cuts keys off."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import sdpa
    from repro_torch.models.attention import causal_mask
    rng = np.random.default_rng(t + window)
    q = torch.as_tensor(rng.normal(size=(b, t, h, d)), device=dev).to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(b, t, hkv, d)),
                            device=dev).to(dtype) for _ in range(2))
    before = flash_attention_cuda.launches
    got = flash_attention_gqa(q, k, v, 0.125, causal=True, window=window)
    assert flash_attention_cuda.launches == before + 1
    mask = causal_mask(t, t, window, device=dev)[None]
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, sdpa(q, k, v, mask, 0.125), rtol=tol,
                               atol=tol)
    if window < t:
        full = flash_attention_gqa(q, k, v, 0.125, causal=True)
        assert (full.float() - got.float()).abs().max() > 0.1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,t,s,h,hkv,causal,window", [
    (4, 128, 128, 1, 1, True, 0), (1, 200, 200, 1, 1, True, 0),
    (2, 37, 101, 4, 2, False, 0), (2, 130, 61, 4, 1, True, 0),
    (2, 300, 200, 8, 2, True, 0), (1, 5, 300, 2, 2, True, 0),
    (2, 200, 200, 4, 2, True, 1), (2, 200, 200, 4, 2, True, 63),
    (1, 300, 300, 2, 1, True, 64), (2, 333, 333, 5, 1, True, 100),
    (1, 1100, 1100, 5, 5, True, 1024), (1, 2100, 2100, 4, 2, True, 1024)])
def test_flash_tc_kernel_matches_plain(dev, d, b, t, s, h, hkv, causal,
                                       window):
    """The tensor-core tile kernel (bfloat16, D 64 and 128): the JAX test
    shapes, ragged T and S, causal T > S and T < S, windows 1, 63, 64, 100
    and 1024. Within the JAX tests' 3e-2 of the bfloat16 plain version,
    within ``FLASH_TC`` of the float32 one, and within 3e-2 of its own
    arithmetic's plain twin, ``flash_attention_tc_torch``."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_gqa_torch, flash_attention_tc_torch)
    rng = np.random.default_rng(t * 7 + s + window + d)
    bf = torch.bfloat16
    q = torch.as_tensor(rng.normal(size=(b, t, h, d)), device=dev).to(bf)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, hkv, d)),
                            device=dev).to(bf) for _ in range(2))
    scale = d ** -0.5
    before = dict(flash_attention_cuda.launches_by_path)
    got = flash_attention_gqa(q, k, v, scale, causal, window)
    after = flash_attention_cuda.launches_by_path
    assert {p: after[p] - before[p] for p in after} == {
        "tile_tc": 1, "tile_simt": 0, "decode_split": 0, "mla_decode": 0,
        "mla_decode_tc": 0}
    assert got.dtype == bf and got.shape == q.shape
    tol = FLASH_TOL[bf]
    torch.testing.assert_close(
        got, flash_attention_gqa_torch(q, k, v, scale, causal, window),
        rtol=tol, atol=tol)
    torch.testing.assert_close(
        got, flash_attention_tc_torch(q, k, v, scale, causal, window),
        rtol=tol, atol=tol)
    assert _flash_limit(got, q, k, v, scale, causal, window, tc=True) <= 1.0


def test_flash_tc_kernel_on_model_and_cache_views(dev):
    """The views the serving path gives the tensor-core kernel:
    ``attention._qkv``'s q, k, v (bfloat16, hd 128) and k, v as slices of a
    fused projection and as cache prefixes (strided: TMA tensor maps over
    each view's own strides); a view off a 16-byte boundary raises."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.models import attention
    cfg = dataclasses.replace(ARCHS["qwen3-32b"].reduced(dtype="bfloat16"),
                              d_model=256, n_heads=4, n_kv_heads=2,
                              head_dim=128)
    gen = torch.Generator(device=dev).manual_seed(3)
    p = attention.init_gqa(gen, cfg)
    x = torch.randn((2, 150, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    q, k, v = attention._qkv(p, x, cfg, torch.arange(150, device=dev))
    scale = attention._scale(cfg.hd)
    assert _flash_limit(flash_attention_gqa(q, k, v, scale, True), q, k, v,
                        scale, True, tc=True) <= 1.0
    qkv = torch.randn((2, 150, 8 * 128), generator=gen,
                      device=dev).to(torch.bfloat16).view(2, 150, 8, 128)
    qf, kf, vf = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert _flash_limit(flash_attention_gqa(qf, kf, vf, scale, True), qf, kf,
                        vf, scale, True, tc=True) <= 1.0
    cache = torch.randn((2, 300, 2, 128), generator=gen,
                        device=dev).to(torch.bfloat16)
    kp, vp = cache[:, :150], cache.flip(1)[:, :150].contiguous()
    assert _flash_limit(flash_attention_gqa(q, kp, vp, scale, False), q, kp,
                        vp, scale, False, tc=True) <= 1.0
    odd = torch.zeros((2, 150, 4 * 128 + 4), dtype=torch.bfloat16,
                      device=dev)[:, :, 4:].view(2, 150, 4, 128)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_gqa(odd, k, v, scale, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,hkv,d", [
    (2, 1, 8, 2, 64), (2, 63, 8, 2, 64), (2, 64, 5, 1, 64),
    (2, 65, 8, 2, 128), (2, 1000, 5, 1, 64), (4, 2112, 64, 8, 128),
    (2, 300, 12, 1, 36), (1, 500, 4, 4, 256), (1, 700, 24, 2, 128)])
def test_flash_decode_split_matches_plain(dev, dtype, b, n, h, hkv, d):
    """The split decode on a strided cache prefix ``[:, :n]``: n = 1, tile
    edges, a partial last tile, the qwen3-32b cell's decode, unaligned rows
    (hd 36 in bfloat16), 256-dim rows and two head groups a KV head (G =
    12). Within the JAX tests' tolerance of the plain version, within 2e-5
    of its own split arithmetic's plain twin on float32 inputs, and in
    bfloat16 within ``FLASH_TIGHT`` of the float32 plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        DECODE_HEADS, decode_splits, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_gqa_torch, flash_decode_split_torch)
    rng = np.random.default_rng(n + d)
    cache_k, cache_v = (torch.as_tensor(rng.normal(size=(b, n + 9, hkv, d)),
                                        device=dev).to(dtype)
                        for _ in range(2))
    kp, vp = cache_k[:, :n], cache_v[:, :n]
    q = torch.as_tensor(rng.normal(size=(b, 1, h, d)), device=dev).to(dtype)
    before = dict(flash_attention_cuda.launches_by_path)
    got = flash_attention_gqa(q, kp, vp, 0.125, causal=False)
    after = flash_attention_cuda.launches_by_path
    assert {p: after[p] - before[p] for p in after} == {
        "tile_tc": 0, "tile_simt": 0, "decode_split": 1, "mla_decode": 0,
        "mla_decode_tc": 0}
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got, flash_attention_gqa_torch(q, kp, vp, 0.125, causal=False),
        rtol=tol, atol=tol)
    n_split = decode_splits(n, b * hkv * -(-(h // hkv) // DECODE_HEADS))
    f = [x.float() for x in (q, kp, vp)]
    torch.testing.assert_close(got.float(), flash_decode_split_torch(
        *f, 0.125, n_split), rtol=2e-5 if dtype == torch.float32 else tol,
        atol=2e-5 if dtype == torch.float32 else tol)
    if dtype == torch.bfloat16:
        assert _flash_limit(got, q, kp, vp, 0.125, False) <= 1.0


def test_flash_decode_split_on_a_ring(dev):
    """A windowed layer's decode: the whole 1,024-slot ring (slot p %
    1024), hymba's 25/5 heads of 64, in bfloat16, within ``FLASH_TIGHT`` of
    the float32 plain version; the same call twice gives the same bits."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    gen = torch.Generator(device=dev).manual_seed(1024)
    ring_k, ring_v = (torch.randn((4, 1024, 5, 64), generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(2))
    q = torch.randn((4, 1, 25, 64), generator=gen,
                    device=dev).to(torch.bfloat16)
    got = flash_attention_gqa(q, ring_k, ring_v, 0.125, causal=False)
    assert _flash_limit(got, q, ring_k, ring_v, 0.125, False) <= 1.0
    assert torch.equal(got, flash_attention_gqa(q, ring_k, ring_v, 0.125,
                                                causal=False))


def _paths() -> dict:
    """The flash file's calls by kernel so far."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    return dict(flash_attention_cuda.launches_by_path)


def _path_delta(before: dict) -> dict:
    return {p: n - before[p] for p, n in _paths().items()}


@pytest.mark.parametrize("b,t,s,h,causal", [
    (2, 64, 64, 4, True), (2, 128, 128, 4, True), (1, 200, 200, 2, True),
    (3, 256, 256, 1, True), (2, 128, 128, 4, False), (2, 37, 101, 4, False),
    (2, 130, 61, 4, True), (2, 300, 200, 5, True), (1, 5, 300, 2, True)])
def test_flash_tc_kernel_mla_widths(dev, b, t, s, h, causal):
    """The tensor-core tile kernel with keys 96 wide and values 64 (MLA's
    prefill): the values a strided view of the up-projection, as
    ``mla_forward`` passes them. Within 3e-2 of the bfloat16 plain
    version and of its own arithmetic's plain twin, and within
    ``FLASH_TC`` of the float32 plain version."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_gqa_torch, flash_attention_tc_torch)
    rng = np.random.default_rng(t * 3 + s)
    bf = torch.bfloat16
    q = torch.as_tensor(rng.normal(size=(b, t, h, 96)), device=dev).to(bf)
    k = torch.as_tensor(rng.normal(size=(b, s, h, 96)), device=dev).to(bf)
    kv = torch.as_tensor(rng.normal(size=(b, s, h, 128)), device=dev).to(bf)
    v = kv[..., 64:]
    scale = 96 ** -0.5
    before = _paths()
    got = flash_attention_gqa(q, k, v, scale, causal)
    assert _path_delta(before) == {"tile_tc": 1, "tile_simt": 0,
                                   "decode_split": 0, "mla_decode": 0,
                                   "mla_decode_tc": 0}
    assert got.dtype == bf and got.shape == (b, t, h, 64)
    tol = FLASH_TOL[bf]
    torch.testing.assert_close(
        got, flash_attention_gqa_torch(q, k, v, scale, causal), rtol=tol,
        atol=tol)
    torch.testing.assert_close(
        got, flash_attention_tc_torch(q, k, v, scale, causal), rtol=tol,
        atol=tol)
    assert _flash_limit(got, q, k, v, scale, causal, tc=True) <= 1.0
    # a score width of 64 (the keys' last 32 columns left out) must fail
    short = flash_attention_gqa_torch(q[..., :64].float(),
                                      k[..., :64].float(), v.float(), scale,
                                      causal).to(bf)
    assert _flash_limit(short, q, k, v, scale, causal, tc=True) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,h,hkv,d,dv,causal", [
    (2, 37, 101, 4, 2, 48, 32, False), (2, 130, 61, 4, 1, 96, 64, True),
    (1, 200, 200, 2, 2, 40, 16, True), (2, 1, 77, 8, 2, 96, 64, False),
    (2, 1, 1000, 40, 40, 96, 64, False), (1, 1, 300, 4, 1, 256, 128, False)])
def test_flash_narrow_values_match_plain(dev, dtype, b, t, s, h, hkv, d, dv,
                                         causal):
    """The CUDA-core tile kernel (T > 1) and the split decode (T = 1) with
    values narrower than keys, as MLA's float32 prefill and its
    non-absorbed decode give them: within the JAX tests' tolerance of the
    plain version, the decode within 2e-5 of its split arithmetic's twin
    on float32 inputs, bfloat16 within ``FLASH_TIGHT`` of the float32
    plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        DECODE_HEADS, decode_splits, path_of)
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_gqa_torch, flash_decode_split_torch)
    rng = np.random.default_rng(t + s + d)
    q = torch.as_tensor(rng.normal(size=(b, t, h, d)), device=dev).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, s + 5, hkv, d)),
                        device=dev).to(dtype)[:, :s]
    v = torch.as_tensor(rng.normal(size=(b, s + 5, hkv, dv)),
                        device=dev).to(dtype)[:, :s]
    path = path_of(q, dv)
    if path == "tile_tc":
        pytest.skip("the tensor-core kernel's (96, 64): the test above")
    before = _paths()
    got = flash_attention_gqa(q, k, v, 0.125, causal)
    delta = _path_delta(before)
    assert delta[path] == 1 and sum(delta.values()) == 1
    assert got.shape == (b, t, h, dv)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got, flash_attention_gqa_torch(q, k, v, 0.125, causal), rtol=tol,
        atol=tol)
    if t == 1:
        n_split = decode_splits(s, b * hkv * -(-(h // hkv) // DECODE_HEADS))
        f = [x.float() for x in (q, k, v)]
        torch.testing.assert_close(
            got.float(), flash_decode_split_torch(*f, 0.125, n_split),
            rtol=2e-5 if dtype == torch.float32 else tol,
            atol=2e-5 if dtype == torch.float32 else tol)
    if dtype == torch.bfloat16:
        assert _flash_limit(got, q, k, v, 0.125, causal) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,r,rd", [
    (2, 1, 4, 32, 8), (2, 63, 4, 32, 8), (2, 65, 4, 32, 8),
    (2, 1000, 5, 64, 16), (1, 200, 45, 256, 32), (4, 2112, 40, 256, 32),
    (1, 777, 40, 256, 32), (2, 300, 128, 256, 64), (2, 333, 16, 256, 32),
    (3, 1029, 40, 256, 32), (1, 70, 20, 72, 8), (2, 400, 40, 64, 64),
    (1, 129, 8, 192, 32), (1, 1, 128, 512, 64), (1, 2048, 128, 512, 64),
    (2, 300, 45, 512, 64), (1, 333, 33, 512, 32), (1, 70, 20, 320, 64),
    (2, 130, 40, 264, 16)])
def test_flash_mla_decode_matches_plain(dev, dtype, b, n, h, r, rd):
    """The latent decode on cache prefixes ``[:, :n]``: n = 1, tile edges,
    ragged n, one split and many, one head group and several (16, 40, 45
    and 128 heads), minicpm3's widths (40 heads over 256 + 32). float32,
    and bfloat16 at widths the tensor cores do not take, on the CUDA cores
    (``"mla_decode"``): float32 within 2e-5 of its plain version, bfloat16
    within ``FLASH_TIGHT`` of the float32 one; bfloat16 with r a multiple
    of 64 and rd 32 or 64 on the tensor cores (``"mla_decode_tc"``) within
    ``FLASH_TC`` of the float32 plain version and within 3e-2 of its own
    arithmetic's plain twin; deepseek-v2's 512 + 64 on both kernels (two
    warpgroups a block on the tensor cores; 32 heads a block on the CUDA
    cores), and r 264 and 320 on the CUDA cores. The plain version equals
    ``sdpa`` over the concatenated keys; two calls give the same bits; one
    launch under its path."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        MLA_TC_R, mla_path_of, mla_splits, mla_tc_splits)
    from repro_torch.kernels.flash_attention.ops import flash_mla_decode
    from repro_torch.kernels.flash_attention.ref import (
        flash_mla_decode_tc_torch, flash_mla_decode_torch, mla_keys, sdpa)
    rng = np.random.default_rng(n + h + r)
    mk = lambda *shape: torch.as_tensor(rng.normal(size=shape),
                                        device=dev).to(dtype)
    ckv, kr = mk(b, n + 9, r)[:, :n], mk(b, n + 9, rd)[:, :n]
    q_lat, q_rope = mk(b, 1, h, r), mk(b, 1, h, rd)
    scale = 0.1
    path = mla_path_of(q_lat, q_rope)
    assert (path == "mla_decode_tc") == (
        dtype == torch.bfloat16 and r in MLA_TC_R and rd in (32, 64))
    before = _paths()
    got = flash_mla_decode(q_lat, q_rope, ckv, kr, scale)
    want_paths = dict.fromkeys(before, 0)
    want_paths[path] = 1
    assert _path_delta(before) == want_paths
    assert got.dtype == dtype and got.shape == (b, 1, h, r)
    assert torch.equal(got, flash_mla_decode(q_lat, q_rope, ckv, kr, scale))
    f = [x.float() for x in (q_lat, q_rope, ckv, kr)]
    want = flash_mla_decode_torch(*f, scale, mla_splits(b, h, n, r))
    plain = sdpa(torch.cat(f[:2], -1), mla_keys(f[2], f[3]),
                 f[2][:, :, None], None, scale)
    torch.testing.assert_close(want, plain, rtol=2e-5, atol=2e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    elif path == "mla_decode":
        lim = 2.0 ** -8 * want.abs() + 2.0 ** -15
        assert float(((got.float() - want).abs() / lim).max()) <= 1.0
    else:
        a32 = sdpa(torch.cat(f[:2], -1), mla_keys(f[2], f[3]),
                   f[2].abs()[:, :, None], None, scale)
        lim = (2.0 ** -8 * want.abs() + (2.0 ** -8 + 2.0 ** -15) * a32
               + 2.0 ** -15)
        assert float(((got.float() - want).abs() / lim).max()) <= 1.0
        twin = flash_mla_decode_tc_torch(q_lat, q_rope, ckv, kr, scale,
                                         mla_tc_splits(b, h, n))
        torch.testing.assert_close(got, twin, rtol=FLASH_TOL[dtype],
                                   atol=FLASH_TOL[dtype])


def test_flash_mla_decode_tc_refuses_unaligned_and_reports(dev):
    """The tensor-core latent decode raises on a cache view off a 16-byte
    boundary (its bulk copies need one) and counts nothing; the occupancy
    and register readings of both redesigned kernels are sane."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_info)
    from repro_torch.kernels.flash_attention.ops import flash_mla_decode
    bf = torch.bfloat16
    ckv = torch.zeros((2, 50, 264), dtype=bf, device=dev)[:, :, 8:]
    kr = torch.zeros((2, 50, 32), dtype=bf, device=dev)
    ql = torch.zeros((2, 1, 40, 256), dtype=bf, device=dev)
    qr = torch.zeros((2, 1, 40, 32), dtype=bf, device=dev)
    flash_mla_decode(ql, qr, ckv, kr, 0.1)        # 16 bytes off: aligned
    odd = torch.zeros((2, 50, 260), dtype=bf, device=dev)[:, :, 4:]
    before = _paths()
    with pytest.raises(ValueError, match="16-byte"):
        flash_mla_decode(ql, qr, odd, kr, 0.1)
    assert _path_delta(before) == dict.fromkeys(before, 0)
    for kernel, x, y in (("tile_tc", 64, 64), ("tile_tc", 96, 64),
                         ("tile_tc", 128, 128), ("tile_tc", 112, 112),
                         ("tile_tc", 192, 128), ("mla_decode_tc", 256, 32),
                         ("mla_decode_tc", 512, 64),
                         ("mla_decode_tc", 512, 32)):
        info = kernel_info(kernel, x, y)
        assert info["blocks_per_sm"] >= 1 and 0 < info["registers"] <= 255
        assert 0 < info["smem_bytes"] <= 232_448
        if (x, y) in ((192, 128), (512, 64), (512, 32)):   # no spill
            assert info["spill_bytes"] == 0, (kernel, x, y, info)


@pytest.mark.parametrize("d,dv", [(64, 64), (96, 64), (128, 128),
                                  (112, 112), (192, 128)])
@pytest.mark.parametrize("b,t,s,h,hkv,causal,window", [
    (2, 300, 200, 4, 2, True, 0), (2, 130, 61, 4, 1, True, 0),
    (2, 37, 101, 4, 2, False, 0), (2, 333, 333, 5, 1, True, 100),
    (1, 1100, 1100, 2, 2, True, 1024)])
def test_flash_tc_kernel_pairs_against_twin(dev, d, dv, b, t, s, h, hkv,
                                            causal, window):
    """The tensor-core tile's five (D, Dv) pairs, causal and ragged,
    bidirectional, windowed: within ``FLASH_TC`` of the float32 plain
    version and within 3e-2 of its arithmetic's twin
    ``flash_attention_tc_torch``; one launch on the tile."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_tc_torch)
    rng = np.random.default_rng(t + s + d + window)
    bf = torch.bfloat16
    q = torch.as_tensor(rng.normal(size=(b, t, h, d)), device=dev).to(bf)
    k = torch.as_tensor(rng.normal(size=(b, s, hkv, d)), device=dev).to(bf)
    v = torch.as_tensor(rng.normal(size=(b, s, hkv, 2 * dv)),
                        device=dev).to(bf)[..., dv:]
    scale = d ** -0.5
    before = _paths()
    got = flash_attention_gqa(q, k, v, scale, causal, window)
    want_paths = dict.fromkeys(before, 0)
    want_paths["tile_tc"] = 1
    assert _path_delta(before) == want_paths
    assert got.shape == (b, t, h, dv)
    assert _flash_limit(got, q, k, v, scale, causal, window, tc=True) <= 1.0
    torch.testing.assert_close(
        got, flash_attention_tc_torch(q, k, v, scale, causal, window),
        rtol=FLASH_TOL[bf], atol=FLASH_TOL[bf])


@pytest.mark.parametrize("absorb", [True, False])
def test_mla_serving_on_card_equals_cpu(dev, absorb):
    """Reduced minicpm3 at minicpm3's attention widths (keys 64 + 32,
    values 64, latent 256), float32 (TF32 off): prefill and 4 decode steps
    on the card against the CPU (logits at rtol 1e-4 with an atol of 1e-4
    times the largest, equal tokens). The card's calls by kernel: the
    prefill on the CUDA-core tile (float32), every decode layer on the
    latent decode (absorbed) or the split decode; then in bfloat16 the
    prefill on the tensor-core tile."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        ARCHS["minicpm3-4b"].reduced(dtype="float32"), d_model=256,
        kv_lora_rank=256, q_lora_rank=64, qk_nope_dim=64, qk_rope_dim=32,
        v_head_dim=64, decode_absorb=absorb)
    params = api.init_fn(cfg, "cpu")(0)
    card = T.tree_map(lambda w: w.detach().to(dev), params)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)))
    before = _paths()
    out = {}
    for where, p, t in (("cpu", params, toks), ("card", card, toks.to(dev))):
        tok, pre = steps.make_prefill_step(cfg)(p, {"tokens": t})
        caches = api.init_caches(cfg, 2, 16, p["embed_tokens"].device)
        for k in ("ckv", "kr"):
            caches["layers"][k][:, :, :12] = pre["layers"][k]
        toks_out, logits = [tok], []
        for s in range(4):
            with torch.inference_mode():
                lg, caches = api.decode_fn(cfg)(p, caches, tok, 12 + s)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            toks_out.append(tok)
            logits.append(lg)
        out[where] = (torch.cat(toks_out, 1).cpu(),
                      torch.cat(logits, 1).cpu())
    dec = "mla_decode" if absorb else "decode_split"
    want_paths = {"tile_tc": 0, "tile_simt": cfg.n_layers,
                  "decode_split": 0, "mla_decode": 0, "mla_decode_tc": 0}
    want_paths[dec] = 4 * cfg.n_layers
    assert _path_delta(before) == want_paths
    assert torch.equal(out["card"][0], out["cpu"][0])
    want = out["cpu"][1]
    torch.testing.assert_close(out["card"][1], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = T.tree_map(lambda w: w.detach().to(dev, torch.bfloat16),
                         params)
    before = _paths()
    steps.make_prefill_step(bcfg)(bparams, {"tokens": toks.to(dev)})
    assert _path_delta(before)["tile_tc"] == cfg.n_layers


SCAN_SHAPES = [(1, 16, 8, 4), (2, 32, 16, 4), (3, 64, 24, 8), (2, 32, 16, 4),
               (2, 1, 3200, 16), (2, 77, 100, 16), (1, 40, 33, 32),
               (2, 50, 20, 3)]


def _scan_inputs(rng, b, t, d, n, dev):
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                   device=dev)
    return (f(b, t, d), torch.nn.functional.softplus(f(b, t, 1) - 2),
            f(b, t, n), f(b, t, n), -torch.exp(f(d, n) * 0.3), f(b, d, n))


@pytest.mark.parametrize("b,t,d,n", SCAN_SHAPES)
def test_ssm_scan_kernel_matches_plain(dev, b, t, d, n):
    """The JAX test shapes, T = 1, ragged D and T, N = 3 and 32, at the JAX
    test's rtol = atol = 1e-5; then with ``s_out`` aliasing ``s0``."""
    from repro_torch.kernels.ssm_scan.ops import ssm_chunk_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_chunk_scan_torch
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_chunk_scan_cuda
    rng = np.random.default_rng(b * 1000 + t * 10 + n)
    xs = _scan_inputs(rng, b, t, d, n, dev)
    before = ssm_chunk_scan_cuda.launches
    y, s = ssm_chunk_scan(*xs)
    assert ssm_chunk_scan_cuda.launches == before + 1
    wy, ws = ssm_chunk_scan_torch(*xs)
    torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, ws, rtol=1e-5, atol=1e-5)
    s0 = xs[5]
    y2, s2 = ssm_chunk_scan(*xs, s_out=s0)
    assert s2 is s0
    assert torch.equal(y2, y) and torch.equal(s0, s)


def test_ssm_scan_kernel_takes_strided_views(dev):
    """u as half of a (B, T, 2D) projection, delta, bv and cv as slices of
    one (B, T, 2N + 1) projection, as the model passes them: no copy, the
    contiguous copies' result bit for bit."""
    from repro_torch.kernels.ssm_scan.ops import ssm_chunk_scan
    rng = np.random.default_rng(7)
    uz = torch.as_tensor(rng.normal(size=(2, 70, 96)), dtype=torch.float32,
                         device=dev)
    bcdt = torch.as_tensor(rng.normal(size=(2, 70, 33)), dtype=torch.float32,
                           device=dev)
    a = -torch.exp(torch.as_tensor(rng.normal(size=(48, 16)),
                                   dtype=torch.float32, device=dev))
    s0 = torch.zeros((2, 48, 16), device=dev)
    views = (uz[..., :48], torch.nn.functional.softplus(bcdt[..., -1:]),
             bcdt[..., :16], bcdt[..., 16:32], a, s0)
    got = ssm_chunk_scan(*views)
    want = ssm_chunk_scan(*(x.contiguous() for x in views))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_hybrid_serving_on_card_equals_cpu(dev):
    """Reduced hymba in float32 (TF32 off): a prefill of 40 tokens (past
    the window of 32), the caches handed to a ring, then 6 decode steps,
    on the card against the CPU: logits at rtol 1e-4 with an atol of 1e-4
    times the largest logit, the same tokens; every layer ran the flash
    and the scan kernels."""
    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_chunk_scan_cuda
    from repro_torch.launch import steps
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS["hymba-1.5b"].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    card = T.tree_map(lambda w: w.detach().to(dev), params)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40)))
    before = (flash_attention_cuda.launches, ssm_chunk_scan_cuda.launches)
    out = {}
    for where, p, t in (("cpu", params, toks), ("card", card, toks.to(dev))):
        tok, pre = steps.make_prefill_step(cfg)(p, {"tokens": t})
        caches = api.init_caches(cfg, 2, 46, p["embed_tokens"].device)
        with torch.inference_mode():
            for pb, cb in zip(pre["blocks"], caches["blocks"]):
                for n in ("k", "v"):
                    s = cb["attn"][n].shape[1]
                    pos = torch.arange(max(0, 40 - s), 40)
                    cb["attn"][n][:, pos % s] = pb["attn"][n][:, pos]
                cb["ssm"]["s"].copy_(pb["ssm"]["s"])
        toks_out, logits = [tok], []
        for s in range(6):
            with torch.inference_mode():
                lg, caches = api.decode_fn(cfg)(p, caches, tok, 40 + s)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            toks_out.append(tok)
            logits.append(lg)
        out[where] = (torch.cat(toks_out, 1).cpu(),
                      torch.cat(logits, 1).cpu())
    after = (flash_attention_cuda.launches, ssm_chunk_scan_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [7 * cfg.n_layers] * 2
    assert torch.equal(out["card"][0], out["cpu"][0])
    want = out["cpu"][1]
    torch.testing.assert_close(out["card"][1], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [5_120, 16_384, 16_385, 1_000_003])
def test_topk_select_launches_per_call(dev, dtype, d):
    """A row of at most 16,384 values: one launch; a longer one: a memset
    and three passes (float32) or two (bfloat16)."""
    from repro_torch.kernels.topk_compress.ref import topk_threshold_torch
    from repro_torch.kernels.topk_compress.topk_compress import (
        select_launches, topk_threshold_cuda)
    x = torch.randn((1, d), generator=torch.Generator(device=dev).manual_seed(
        d), device=dev).to(dtype)
    k = max(1, d // 100)
    launched = _chip_smoke().device_ops(lambda: topk_threshold_cuda(x, k))
    assert launched == select_launches(dtype, d) == (
        1 if d <= 16_384 else 3 + (dtype == torch.float32))
    assert torch.equal(_raw(topk_threshold_cuda(x, k)),
                       _raw(topk_threshold_torch(x, k)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_candidate_buffer_and_overflow(dev, dtype):
    """Rows of 100,003 values that start off 16 bytes (as a view one to
    three elements into a buffer too), whose first pass picks a bin that
    fits the candidate buffer (6,248 keys: random; 5,000 keys in [1, 1.125)
    above small ones) or overflows it (every key in one first digit; heavy
    ties): the threshold, values and indices equal the plain version's bit
    for bit."""
    from repro_torch.kernels.topk_compress.ref import (topk_compress_torch,
                                                       topk_threshold_torch)
    from repro_torch.kernels.topk_compress.topk_compress import (
        topk_compress_cuda, topk_threshold_cuda)
    rng = np.random.default_rng(17)
    d, k = 100_003, 1_000
    rows = rng.standard_normal((4, d))
    rows[1] = (1 + rng.random(d) / 8.5) * rng.choice([-1, 1], d)
    rows[2] = np.where(rng.random(d) < 0.9, 1.5, -1.5) * (rng.random(d) < 0.8)
    rows[3] = rng.random(d) / 128
    rows[3, rng.choice(d, 5_000, replace=False)] = 1 + rng.random(5_000) / 8.5
    for off in (0, 1, 3):
        buf = torch.zeros(4 * d + off, dtype=dtype, device=dev)
        x = buf[off:].view(4, d)
        x.copy_(torch.as_tensor(rows, device=dev).to(dtype))
        t = topk_threshold_cuda(x, k)
        assert torch.equal(_raw(t), _raw(topk_threshold_torch(x, k)))
        v, i = topk_compress_cuda(x, k)
        wv, wi = topk_compress_torch(x, k)
        assert torch.equal(i, wi) and torch.equal(_raw(v), _raw(wv))


@pytest.mark.parametrize("n", [1, 5, 16, 32])
@pytest.mark.parametrize("t", [1, 70])
def test_ssm_scan_kernel_every_lane_count_in_place(dev, n, t):
    """N = 1, 5, 16, 32 (one, two, four and eight lanes a channel), a
    decode step (T = 1) and a prefill, the state written over s0: within
    1e-5 of the plain version, and equal to the call with a fresh s_out."""
    from repro_torch.kernels.ssm_scan.ops import ssm_chunk_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_chunk_scan_torch
    rng = np.random.default_rng(n * 100 + t)
    xs = _scan_inputs(rng, 3, t, 70, n, dev)
    wy, ws = ssm_chunk_scan_torch(*xs)
    y1, s1 = ssm_chunk_scan(*xs)
    s0 = xs[5].clone()
    y, s = ssm_chunk_scan(*xs[:5], s0, s_out=s0)
    assert s is s0
    assert torch.equal(y, y1) and torch.equal(s, s1)
    torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, ws, rtol=1e-5, atol=1e-5)


def test_ssm_scan_kernel_within_the_derived_bound(dev):
    """(2, 2000, 96, 16): elementwise within ``scan_f64_bound``'s limit of
    the float64 plain version (the PTX ISA's ex2 error)."""
    from repro_torch.kernels.ssm_scan.ops import ssm_chunk_scan
    chip_smoke = _chip_smoke()
    xs = _scan_inputs(np.random.default_rng(2000), 2, 2000, 96, 16, dev)
    y, s = ssm_chunk_scan(*xs)
    y64, s64, ylim, slim, _ = chip_smoke.scan_f64_bound(*xs, keep_from=0)
    assert chip_smoke._over(y, y64, ylim)[2]
    assert chip_smoke._over(s, s64, slim)[2]


@pytest.mark.parametrize("admit", [False, True])
def test_fleet_loop_on_card_equals_host_and_cpu(dev, admit):
    """The penalty loop with a shared core on the card: the device loop
    equals the host loop and the CPU loop bitwise, round for round, and
    each round launches the level fold and the color once a level, and
    never the standalone min-plus."""
    from repro_torch.collectives import build_fleet
    from repro_torch.core import build_fleet_forest, sample_load
    from repro_torch.engine import solve_fleet
    fleet = build_fleet(2, 2, 2, 4, spine_rho=8.0)
    trees = [tp.tree for tp in fleet.topos]
    tree_of = [0, 0, 0, 1, 1, 1]
    loads = [sample_load(trees[g], "power-law", seed=7 + i)
             for i, g in enumerate(tree_of)]
    kw = dict(core_rho=fleet.core_rho, core_path=fleet.core_path,
              record_rounds=True, rho_weighted=True)
    if admit:
        kw["residual"] = [np.full(tr.n, 2, np.int64) for tr in trees]
    before = (level_fold_cuda.launches, color_level_cuda.launches,
              minplus_cuda.launches)
    got = solve_fleet(trees, loads, tree_of, 3, **kw)
    launched = (level_fold_cuda.launches - before[0],
                color_level_cuda.launches - before[1],
                minplus_cuda.launches - before[2])
    f, _ = build_fleet_forest(trees, loads, tree_of, core_rho=fleet.core_rho,
                              core_path=fleet.core_path)
    chip_smoke = _chip_smoke()
    per = got.rounds * chip_smoke.expected_launches(f)[0]
    assert launched == (per, per, 0)
    diff = chip_smoke.congestion_diff
    assert diff(got, solve_fleet(trees, loads, tree_of, 3,
                                 device_loop=False, **kw)) == []
    assert diff(got, solve_fleet(trees, loads, tree_of, 3,
                                 options=EngineOptions(device="cpu"),
                                 **kw)) == []


def test_messages_up_forest_on_card_equals_cpu(dev):
    from repro_torch.core import messages_up_forest, random_tree
    rng = np.random.default_rng(4)
    trees, loads = [], []
    for s in range(16):
        trees.append(random_tree(int(rng.integers(1, 200)), seed=s))
        loads.append(rng.integers(0, 9, trees[-1].n))
    f = build_forest(trees, loads)
    blue = (rng.random(f.mask.shape) < 0.3) & f.mask
    got = messages_up_forest(f, blue)
    want = messages_up_forest(f, blue, options=EngineOptions(device="cpu"))
    assert got.dtype == np.int64 and np.array_equal(got, want)


def _runtime_state(o) -> tuple:
    """What an orchestrator event leaves: masks, program, ledgers, the job
    registry, event records and cache counters, as comparable values."""
    p = o.program
    return (o.blue.tobytes(), p.utilization, p.total_network_messages,
            p.n_slots, [type(op).__name__ for op in p.ops],
            [r.tobytes() for r in o._residuals],
            [(j.job_id, j.tree, j.blue.tobytes(), j.utilization)
             for j in o.jobs.values()],
            list(o.utilization_history), list(o.degraded_events),
            o.last_admission, o.preplan_cache_stats())


def _runtime_script(options) -> list:
    """An event script on a small orchestrator; the state after each."""
    from repro_torch.collectives import fleet_tree
    from repro_torch.runtime import (Orchestrator, OrchestratorConfig,
                                     PreemptionPolicy)
    o = Orchestrator(fleet_tree(2, 4, 4), OrchestratorConfig(k=3, capacity=2),
                     options=options)
    states = [_runtime_state(o)]
    blue = int(np.nonzero(o.blue)[0][0])
    for event in (
            lambda: o.preplan_failures([[0], [4, 5, 6, 7]]),
            lambda: o.preplan_switch_failures(),
            lambda: o.on_failure([0]),
            lambda: o.on_switch_failure([blue]),
            lambda: o.on_link_degrade({3: 0.5}),
            lambda: o.begin_workloads(3, congestion_aware=True,
                                      device_admission=True,
                                      capacity_priced=True, max_rounds=3),
            lambda: o.begin_workloads(6, congestion_aware=True,
                                      device_admission=True, max_rounds=2,
                                      preemption=PreemptionPolicy()),
            lambda: o.on_switch_degrade({blue + 1: 0.5}),
            lambda: o.release_workloads(sorted(o.jobs)[:2]),
            lambda: o.on_recover([0])):
        event()
        states.append(_runtime_state(o))
    return states


def test_runtime_script_on_card_equals_cpu(dev):
    """The orchestrator's events with the solves on the card leave the
    same state as with them on the CPU, bitwise, event by event."""
    got = _runtime_script(EngineOptions(device="cuda"))
    want = _runtime_script(EngineOptions(device="cpu"))
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a == b, f"state after event {i} differs"


def test_runtime_cached_recovery_launches_no_solve_kernel(dev):
    from repro_torch.collectives import fleet_tree
    from repro_torch.runtime import Orchestrator, OrchestratorConfig
    o = Orchestrator(fleet_tree(2, 4, 4), OrchestratorConfig(k=3, capacity=2),
                     options=EngineOptions(device="cuda"))
    counts = lambda: (level_fold_cuda.launches, color_level_cuda.launches,
                      minplus_cuda.launches)
    # each preplan in the state its failure happens in (the cache keys on
    # the dead devices and the failed switches)
    o.preplan_switch_failures()
    before = counts()
    o.on_switch_failure([int(np.nonzero(o.blue)[0][0])])
    assert counts() == before
    o.preplan_failures([[0, 1]])
    before = counts()
    o.on_failure([0, 1])
    assert counts() == before
    before = counts()
    o.on_link_degrade({2: 0.5})                   # not preplanned: a solve
    levels = _chip_smoke().expected_launches(
        build_forest([o.topo.tree], [o.topo.load]))[0]
    assert tuple(a - b for a, b in zip(counts(), before)) == (levels,
                                                              levels, 0)
    assert o.preplan_cache_stats()["hits"] == 2


def _chaos_run(options):
    """A 12-event seeded chaos run (admissions included) on a small
    orchestrator; the report and the state it leaves."""
    from repro_torch.collectives import fleet_tree
    from repro_torch.runtime import (ChaosHarness, Orchestrator,
                                     OrchestratorConfig, generate_scenario)
    cfg = OrchestratorConfig(k=2, capacity=2, straggler_quantile=0.5,
                             straggler_patience=2)
    topo = fleet_tree(2, 4, 4)
    events = generate_scenario(topo, n_events=12, seed=3, cfg=cfg,
                               admits=True)
    o = Orchestrator(topo, cfg, options=options)
    o.preplan_switch_failures()
    report = ChaosHarness(o, verify_cache_hits=True).run(events)
    return report, _runtime_state(o)


def test_chaos_run_on_card_equals_cpu(dev):
    """The chaos harness with the solves (and the cache-hit checks' fresh
    solves) on the card: the same records and state as on the CPU."""
    got, got_state = _chaos_run(EngineOptions(device="cuda"))
    want, want_state = _chaos_run(EngineOptions(device="cpu"))
    assert got.invariant_checks == want.invariant_checks == 12
    assert got.records == want.records
    assert (got.replans, got.cache_hits, got.stale) == (
        want.replans, want.cache_hits, want.stale)
    assert got_state == want_state


def test_chaos_trainer_on_card_bitwise(dev, tmp_path):
    """ChaosTrainer on 8 workers on the card: the lossless steps under
    degraded programs bitwise the pristine program's, two restores."""
    from repro_torch.launch.train import dp_fleet
    from repro_torch.runtime import (ChaosHarness, ChaosTrainer, FaultEvent,
                                     Orchestrator, OrchestratorConfig)
    o = Orchestrator(dp_fleet(8), OrchestratorConfig(k=2),
                     options=EngineOptions(device="cuda"))
    tr = ChaosTrainer(o, seq=16, global_batch=8, ckpt_dir=str(tmp_path),
                      ckpt_every=2)
    assert tr.device.type == "cuda"
    blue = [int(s) for s in np.nonzero(o.blue)[0]]
    events = [FaultEvent("degrade_switch", rates=((blue[0], 0.5),)),
              FaultEvent("degrade_switch", rates=((blue[1], 0.25),)),
              FaultEvent("crash"),
              FaultEvent("recover_switch_capacity", rates=((blue[0], 1.0),)),
              FaultEvent("fail_device", devices=(3,)),
              FaultEvent("crash"),
              FaultEvent("recover_device", devices=(3,)),
              FaultEvent("recover_switch_capacity", rates=((blue[1], 1.0),))]
    before = segment_reduce_cuda.launches
    report = ChaosHarness(o, trainer=tr).run(events)
    s = report.train
    assert s["steps"] == 8 and s["restores"] == 2
    assert s["bitwise_checks"] >= 2 and report.invariant_checks == 8
    assert segment_reduce_cuda.launches > before
    assert all(np.isfinite([r["loss"] for r in report.records]))


# -- the rank executor: ranks sharing the card over gloo ----------------------

DIST_D = 1_000_003              # odd: no 16-byte rows


def _dist_programs(world):
    from repro_torch.collectives import plan
    from repro_torch.launch.train import dp_fleet
    topo = dp_fleet(world)
    cpu = EngineOptions(device="cpu")
    return {f"k{k}": plan(topo, k, options=cpu).program
            for k in range(min(2, topo.tree.n) + 1)}


def _dist_stack(world, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((world, DIST_D), generator=gen, device=dev)
    x = x * torch.exp(2 * torch.randn(x.shape, generator=gen, device=dev))
    return x.to(dtype)


def _dist_bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).cpu().numpy()


def _dist_rank(rank, world, store, out):
    """A rank on the card (``python tests/test_torch_cuda.py --dist-ranks N
    OUT``): ``reduce_local`` of its row over gloo, its bits and launches."""
    import torch.distributed as dist

    from repro_torch.collectives import reduce_local
    from repro_torch.collectives.tree_allreduce import rank_program
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {}
        for name, prog in _dist_programs(world).items():
            for dtype in (torch.float32, torch.bfloat16):
                x = _dist_stack(world, dtype, dev)[rank].clone()
                before = segment_reduce_cuda.launches
                got = reduce_local(x, prog)
                key = f"{name}|{dtype}"
                res[key] = _dist_bits(got)
                res[f"launches|{key}"] = np.asarray(
                    [segment_reduce_cuda.launches - before,
                     rank_program(prog, rank, dev).n_reduce])
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def test_rank_executor_two_ranks_share_the_card_over_gloo(dev, tmp_path):
    """Two ranks on one card, gloo (their slabs staged through pinned host
    memory): each rank's result bitwise the single-card executor's on the
    stacked inputs, each rank's launches its rank program's Reduces."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.collectives import tree_allreduce
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, __file__, "--dist-ranks", "2",
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for name, prog in _dist_programs(2).items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}|{dtype}"
            want = _dist_bits(tree_allreduce(_dist_stack(2, dtype, dev), prog))
            for r in range(2):
                np.testing.assert_array_equal(got[r][key], want,
                                              err_msg=f"{key} rank {r}")
                ran, n_reduce = got[r][f"launches|{key}"]
                assert ran == n_reduce, (key, r)


# ---------------------------------------------------------------------------
# the scan's backward kernel and training the hybrid and xLSTM families
# ---------------------------------------------------------------------------

SCAN_BWD_SHAPES = [(1, 16, 8, 4), (2, 32, 16, 4), (3, 64, 24, 8),
                   (2, 32, 16, 32), (2, 1, 3200, 16), (2, 77, 100, 16),
                   (1, 45, 33, 5), (2, 300, 70, 16)]


@pytest.mark.parametrize("with_gs", [True, False])
@pytest.mark.parametrize("b,t,d,n", SCAN_BWD_SHAPES)
def test_ssm_scan_bwd_kernel_matches_plain(dev, b, t, d, n, with_gs):
    """The backward kernel against the float64 plain backward within
    ``chip_smoke.SCAN_BWD_REL`` of the backward on absolute values
    (``scan_bwd_magnitude``), bv/cv strided at N = 16; two calls bitwise;
    one counted launch a call."""
    from repro_torch.kernels.ssm_scan.ref import ssm_chunk_scan_bwd_torch
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_chunk_scan_bwd_cuda
    cs = _chip_smoke()
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + t * 10 + n)
    cs.DEVICE = dev
    xs = cs.scan_bwd_inputs(gen, b, t, d, n, strided=n == 16)
    gs = xs[7] if with_gs else None
    before = ssm_chunk_scan_bwd_cuda.launches
    got = ssm_chunk_scan_bwd_cuda(*xs[:7], gs)
    again = ssm_chunk_scan_bwd_cuda(*xs[:7], gs)
    assert ssm_chunk_scan_bwd_cuda.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    x64 = [x.double() for x in xs]
    want = ssm_chunk_scan_bwd_torch(*x64[:7], x64[7] if with_gs else None)
    mag = cs.scan_bwd_magnitude(*xs[:7], xs[7] if with_gs
                                else torch.zeros_like(xs[7]))
    assert cs.scan_bwd_over(got, want, mag)[1] <= 1.0


@pytest.mark.parametrize("b,t,d,n", [(1, 16, 8, 4), (2, 1, 3200, 16),
                                     (2, 77, 100, 16), (1, 45, 33, 5),
                                     (2, 100, 16, 32)])
def test_ssm_scan_checkpoints_leave_the_forward_bitwise(dev, b, t, d, n):
    """The forward with the run checkpoints written: y and s_final the
    same bits as without, one launch each; each checkpoint the final
    state of the forward over the steps before its run, bit for bit, and
    the columns past N zero."""
    from repro_torch.kernels.ssm_scan.ref import RUN
    from repro_torch.kernels.ssm_scan.ssm_scan import (scan_checkpoints,
                                                       ssm_chunk_scan_cuda)
    cs = _chip_smoke()
    cs.DEVICE = dev
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + t * 10 + n)
    xs = cs.scan_bwd_inputs(gen, b, t, d, n, strided=n == 16)[:6]
    ck = scan_checkpoints(xs[0], xs[2])
    before = ssm_chunk_scan_cuda.launches
    y, s = ssm_chunk_scan_cuda(*xs, ck=ck)
    y2, s2 = ssm_chunk_scan_cuda(*xs)
    assert ssm_chunk_scan_cuda.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert torch.equal(ck[0, 0, :, :n], xs[5][0])
    assert not ck[..., n:].any()
    for k in range(1, ck.shape[1]):
        head = ssm_chunk_scan_cuda(*(x[:, :k * RUN] for x in xs[:4]),
                                   *xs[4:])[1]
        assert torch.equal(ck[:, k, :, :n], head), k


@pytest.mark.parametrize("with_gs", [True, False])
@pytest.mark.parametrize("b,t,d,n", [(2, 32, 16, 4), (2, 1, 3200, 16),
                                     (2, 300, 70, 16), (1, 45, 33, 5),
                                     (1, 4096, 3200, 16)])
def test_ssm_scan_bwd_kernel_fed_checkpoints(dev, b, t, d, n, with_gs):
    """The backward fed the forward's checkpoints, as ``SSMScan`` calls
    it, equals the backward that has the forward write its own, bit for
    bit, and two calls agree; launches: without checkpoints one forward
    and one backward a call, with them one backward."""
    from repro_torch.kernels.ssm_scan.ssm_scan import (
        scan_checkpoints, ssm_chunk_scan_bwd_cuda, ssm_chunk_scan_cuda)
    cs = _chip_smoke()
    cs.DEVICE = dev
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + t * 10 + n)
    xs = cs.scan_bwd_inputs(gen, b, t, d, n, strided=n == 16)
    gs = xs[7] if with_gs else None
    f0, b0 = ssm_chunk_scan_cuda.launches, ssm_chunk_scan_bwd_cuda.launches
    own = ssm_chunk_scan_bwd_cuda(*xs[:7], gs)
    assert (ssm_chunk_scan_cuda.launches - f0,
            ssm_chunk_scan_bwd_cuda.launches - b0) == (1, 1)
    ck = scan_checkpoints(xs[0], xs[2])
    ssm_chunk_scan_cuda(*xs[:6], ck=ck)
    f0, b0 = ssm_chunk_scan_cuda.launches, ssm_chunk_scan_bwd_cuda.launches
    fed = ssm_chunk_scan_bwd_cuda(*xs[:7], gs, ck=ck)
    again = ssm_chunk_scan_bwd_cuda(*xs[:7], gs, ck=ck)
    assert (ssm_chunk_scan_cuda.launches - f0,
            ssm_chunk_scan_bwd_cuda.launches - b0) == (0, 2)
    assert all(torch.equal(x, y) for x, y in zip(own, fed))
    assert all(torch.equal(x, y) for x, y in zip(fed, again))


def _reduced_grads(cfg, params, toks):
    from repro_torch import tree as T
    from repro_torch.models import api
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _ = api.loss_fn(cfg)(params, batch)
    return loss.detach(), torch.autograd.grad(loss, T.leaves(params))


@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-125m"])
def test_training_on_card_equals_cpu_and_launches(dev, name):
    """Reduced hymba (a window of 32 crossed at T = 48) and xLSTM in
    float32, TF32 off: loss and every gradient on the card against the
    CPU (rtol 1e-4, atol 1e-4 of the leaf's largest |gradient|); hymba's
    scan forward launched twice a layer (the forward and the remat
    recompute) and its backward once a layer; xLSTM none; without grad
    one forward a layer and no backward."""
    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ssm_scan.ssm_scan import (ssm_chunk_scan_bwd_cuda,
                                                       ssm_chunk_scan_cuda)
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[name].reduced(dtype="float32", chunk_size=16)
    params = api.init_fn(cfg, dev)(0)
    cpu = T.tree_map(lambda p: p.detach().cpu().requires_grad_(), params)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 49)))
    f0, b0 = ssm_chunk_scan_cuda.launches, ssm_chunk_scan_bwd_cuda.launches
    loss, grads = _reduced_grads(cfg, params, toks.to(dev))
    scan = name == "hymba-1.5b"
    assert ssm_chunk_scan_cuda.launches - f0 == 2 * cfg.n_layers * scan
    assert ssm_chunk_scan_bwd_cuda.launches - b0 == cfg.n_layers * scan
    closs, cgrads = _reduced_grads(cfg, cpu, toks)
    torch.testing.assert_close(loss.cpu(), closs, rtol=1e-4, atol=0)
    for (path, _), g, w in zip(T.leaves_with_paths(cpu), grads, cgrads):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(
            w.abs().max()), msg=path)
    f0, b0 = ssm_chunk_scan_cuda.launches, ssm_chunk_scan_bwd_cuda.launches
    with torch.no_grad():
        api.prefill_fn(cfg)(params, {"tokens": toks[:, :32].to(dev)})
    assert ssm_chunk_scan_cuda.launches - f0 == cfg.n_layers * scan
    assert ssm_chunk_scan_bwd_cuda.launches == b0


if __name__ == "__main__":
    import sys
    import tempfile

    import torch.multiprocessing as mp
    if sys.argv[1:2] != ["--dist-ranks"]:
        sys.exit("usage: test_torch_cuda.py --dist-ranks N OUT")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dist_rank, args=(int(sys.argv[2]), f"{tmp}/store",
                                   sys.argv[3]), nprocs=int(sys.argv[2]))


@pytest.mark.parametrize("t", [8, 1])
@pytest.mark.parametrize("s", [1_500, 4_096])
def test_flash_short_queries_over_long_keys_non_causal(dev, t, s):
    """whisper's cross attention: t query rows over s frames, non-causal,
    bfloat16 at head width 64 (20 heads, one KV head each): t = 8 on the
    tensor-core tile (8 of a tile's 64 rows; the tile's rows past t must
    not reach the next batch row's output, and keys past a ragged s are
    masked), within ``FLASH_TC`` of the float32 plain version and within
    3e-2 of its twin; t = 1 on the split decode within ``FLASH_TIGHT``
    and 3e-2 of its twin. q is drawn with mean 1 and k with mean -1, so
    every real score lies near -8 and the zero keys a tile reads past s
    would outweigh them if let in (``tests/test_torch_flash_tc.py``)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        DECODE_HEADS, decode_splits)
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_tc_torch, flash_decode_split_torch)
    rng = np.random.default_rng(s + t)
    bf = torch.bfloat16
    b, h, d = 3, 20, 64
    q = torch.as_tensor(rng.normal(1.0, size=(b, t, h, d)), device=dev).to(bf)
    k = torch.as_tensor(rng.normal(-1.0, size=(b, s, h, d)),
                        device=dev).to(bf)
    v = torch.as_tensor(rng.normal(size=(b, s, h, d)), device=dev).to(bf)
    scale = d ** -0.5
    before = _paths()
    got = flash_attention_gqa(q, k, v, scale, causal=False)
    path = "tile_tc" if t > 1 else "decode_split"
    want_paths = dict.fromkeys(before, 0)
    want_paths[path] = 1
    assert _path_delta(before) == want_paths
    assert got.shape == (b, t, h, d)
    assert _flash_limit(got, q, k, v, scale, False, tc=t > 1) <= 1.0
    twin = (flash_attention_tc_torch(q, k, v, scale, False) if t > 1 else
            flash_decode_split_torch(q.float(), k.float(), v.float(), scale,
                                     decode_splits(s, b * h * -(
                                         -1 // DECODE_HEADS))))
    torch.testing.assert_close(got.float(), twin.float(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("name", ["llava-next-34b", "whisper-large-v3"])
def test_vlm_and_encdec_serving_on_card_equals_cpu(dev, name):
    """Reduced llava (8 prefix embeddings ahead of 12 tokens) and reduced
    whisper (40 frames, 8 tokens) in float32 (TF32 off): prefill and 4
    greedy decode steps on the card against the CPU, logits at rtol 1e-4
    with an atol of 1e-4 times the largest, equal tokens; the card's calls
    by kernel: every prefill attention on the CUDA-core tile, every decode
    one on the split decode."""
    from repro_torch import tree as T
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[name].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    card = T.tree_map(lambda w: w.detach().to(dev), params)
    rng = np.random.default_rng(2)
    if cfg.is_encoder_decoder:
        batch = {"frames": torch.as_tensor(rng.normal(
            size=(2, 40, cfg.d_model)), dtype=torch.float32)}
        t, calls = 8, cfg.n_encoder_layers + 2 * cfg.n_layers
    else:
        batch = {"prefix_embeds": torch.as_tensor(0.02 * rng.normal(
            size=(2, cfg.n_prefix_embeds, cfg.d_model)), dtype=torch.float32)}
        t, calls = 12, cfg.n_layers
    batch["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab, (2, t)))
    n = api.decode_start(batch)
    before = _paths()
    out = {}
    for where, p in (("cpu", params), ("card", card)):
        bt = {k: x.to(p["embed_tokens"].device) for k, x in batch.items()}
        tok, pre = steps.make_prefill_step(cfg)(p, bt)
        caches = api.decode_caches(cfg, pre, bt, 4)
        toks_out, logits = [tok], []
        for s in range(4):
            with torch.inference_mode():
                lg, caches = api.decode_fn(cfg)(p, caches, tok, n + s)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            toks_out.append(tok)
            logits.append(lg)
        out[where] = (torch.cat(toks_out, 1).cpu(),
                      torch.cat(logits, 1).cpu())
    want_paths = dict.fromkeys(before, 0)
    want_paths["tile_simt"] = calls
    want_paths["decode_split"] = 4 * (2 if cfg.is_encoder_decoder else 1) \
        * cfg.n_layers
    assert _path_delta(before) == want_paths
    assert torch.equal(out["card"][0], out["cpu"][0])
    want = out["cpu"][1]
    torch.testing.assert_close(out["card"][1], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
