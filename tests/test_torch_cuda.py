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
