"""CUDA kernels vs their plain torch versions, on the card.

Marked ``cuda``: skipped where no card is present (decided in a fixture,
so every xdist worker collects the same tests). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every comparison is bitwise (``torch.equal``): the kernels keep the plain
versions' candidate sets, child order, summation order and separate
roundings (no FMA).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Tree, build_forest
from repro_torch.core.tropical import BIG
from repro_torch.engine import EngineOptions, solve_batch, solve_forest
from repro_torch.kernels.minplus.levelfold import (level_fold,
                                                   level_fold_cuda,
                                                   level_fold_torch,
                                                   minplus_fused)
from repro_torch.kernels.minplus.minplus import minplus_cuda
from repro_torch.kernels.minplus.ops import minplus
from repro_torch.kernels.segment_reduce.ops import reduce_rows, segment_reduce
from repro_torch.kernels.segment_reduce.ref import segment_reduce_torch
from repro_torch.kernels.segment_reduce.segment_reduce import (
    segment_reduce_cuda)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,C,W,max_c,nl,kcap", [
    (1, 2, 1, 1, 2, 1), (2, 5, 3, 2, 3, 4), (3, 40, 37, 4, 5, 9),
    (2, 17, 8, 8, 14, 65), (1, 9, 5, 3, 33, 129)])
def test_level_fold_kernel_bitwise(dev, dtype, B, C, W, max_c, nl, kcap):
    rng = np.random.default_rng(B * 100 + C * 10 + max_c)
    xs = _rows(rng, (B, C, nl, kcap), dtype, dev, 0.05)
    xb = _rows(rng, (B, C, kcap), dtype, dev, 0.05)
    xs[:, -1] = 0
    xb[:, -1] = 0
    kid = rng.integers(0, C, size=(B, W, max_c))
    kid[rng.random(kid.shape) < 0.3] = C - 1
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
    folds, chains = level_fold_cuda.launches, minplus_cuda.launches
    got = solve_batch(trees, loads, k, avails, options=opts)
    assert level_fold_cuda.launches > folds
    assert minplus_cuda.launches > chains
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
    rng = np.random.default_rng(3)
    flat = torch.as_tensor(rng.normal(size=(40, 1028)), dtype=torch.float32,
                           device=dev)
    rows = torch.tensor([0, 10, 33], device=dev)
    mask = torch.as_tensor(rng.random((3, 7)) < 0.6, device=dev)
    mask[2, 5:] = False
    want = segment_reduce_torch(flat, mask, rows)
    assert torch.equal(reduce_rows(flat, mask, rows), want)
    out = flat.clone()
    reduce_rows(out, mask, rows, inplace=True)
    expect = flat.clone()
    expect[rows] = want
    assert torch.equal(out, expect)


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
        _, prog = train.reduce_program(8, 2, device=where)
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
