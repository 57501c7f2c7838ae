"""``collectives.axis_ops.psum`` on 4 gloo CPU ranks: over the 4, where a
tensor's values split into 4 equal chunks it is a reduce-scatter (an
all-to-all, then each rank's chunk summed in rank order in float32) and
an all-gather of the sums; else, and over a group of 2 (``model``), one
all-gather and the sum of every copy. Each gives the same bits as the sum
of every copy, in rank order, accumulated in float32 and rounded once, on
every rank; so does ``varying``'s backward, the same sum of the
gradients. The ranks are one spawn for the module (this file
run as ``python tests/test_torch_axis_ops.py --ranks DIR``).
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
#: (shape, dtype): splits into 4 chunks, or not
CASES = [((8, 6), "float32"), ((4, 3, 5), "bfloat16"), ((3,), "float32"),
         ((2, 5), "bfloat16")]


def _value(rank: int, shape, dtype) -> torch.Tensor:
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(shape, generator=g) * 10.0 ** (rank - 1)
    return x.to(getattr(torch, dtype))


def _want(shape, dtype, ranks=range(WORLD)) -> torch.Tensor:
    """The sum of ``ranks``' values in their order, in float32."""
    ranks = list(ranks)
    acc = _value(ranks[0], shape, dtype).to(torch.float32)
    for r in ranks[1:]:
        acc = acc + _value(r, shape, dtype).to(torch.float32)
    return acc.to(getattr(torch, dtype))


def _rank_body(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.collectives import axis_ops as ops
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_test_mesh(2, 2)
        out = {"coord": np.asarray(mesh.get_coordinate())}
        for group, names in (("all", tuple(mesh.mesh_dim_names)),
                             ("model", ("model",))):
            ax = ops.axis(mesh, names)
            for i, (shape, dtype) in enumerate(CASES):
                x = _value(rank, shape, dtype)
                with ops.exchange_log() as log:
                    s = ops.psum(x, ax)
                out[f"{group}-psum{i}"] = s.to(torch.float32).numpy()
                out[f"{group}-ops{i}"] = np.asarray([r["op"] for r in log])
                y = x.clone().requires_grad_()
                ops.varying(y, ax).backward(_value(rank, shape, dtype))
                out[f"{group}-grad{i}"] = y.grad.to(torch.float32).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(out_dir):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_body, args=(WORLD, os.path.join(tmp, "store"),
                                   out_dir), nprocs=WORLD)


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run([sys.executable, __file__, "--ranks", tmp],
                              capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(WORLD)]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_psum_is_the_rank_ordered_float32_sum_on_every_rank(ranks, i):
    shape, dtype = CASES[i]
    want = _want(shape, dtype).to(torch.float32).numpy()
    split = int(np.prod(shape)) % WORLD == 0
    for got in ranks:
        np.testing.assert_array_equal(got[f"all-psum{i}"], want)
        np.testing.assert_array_equal(got[f"all-grad{i}"], want)
        assert list(got[f"all-ops{i}"]) == (
            ["all_to_all", "all_gather"] if split else ["all_gather"])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_psum_over_two_ranks_is_one_all_gather(ranks, i):
    """Over ``model`` (global ranks 2d and 2d + 1 of dp block d) the sum
    of the pair, in their order, from one all-gather."""
    shape, dtype = CASES[i]
    for got in ranks:
        d = int(got["coord"][0])
        want = _want(shape, dtype, (2 * d, 2 * d + 1)).to(
            torch.float32).numpy()
        np.testing.assert_array_equal(got[f"model-psum{i}"], want)
        np.testing.assert_array_equal(got[f"model-grad{i}"], want)
        assert list(got[f"model-ops{i}"]) == ["all_gather"]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks"]:
        _spawn(sys.argv[2])
    else:
        sys.exit("usage: test_torch_axis_ops.py --ranks OUT_DIR")
