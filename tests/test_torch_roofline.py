"""The port's roofline (``repro_torch.launch.roofline``) vs the JAX
package's ``launch/roofline.py``.

* ``model_flops`` equals JAX's exactly for every config, the four
  assigned shapes and the three modes.
* ``roofline_terms`` equals JAX's on the same stats (the same keys and
  arithmetic) with the port's constants set to JAX's TPU figures; with its
  own it reads the H100 data sheet's (NVIDIA H100 SXM at 700 W: 989
  TFLOP/s bfloat16 dense, 67 TFLOP/s float32, 3.35 TB/s and 80 GB of HBM;
  NVLink 900 GB/s, one direction of it).
* ``StepCounter``'s dot FLOPs of reduced qwen3-32b's prefill on one
  process equal JAX's ``analyze_hlo`` of ``jit(make_prefill_step)`` at
  T = 64 exactly. At T = 4,096 JAX's prefill takes ``sdpa_blocked``
  (blocks of 2,048) and computes nq (nq + 1) / 2 of the nq^2 score
  tiles, where the flash kernel's plain version computes the whole
  square: the gap is (nq^2 - nq (nq + 1) / 2) / nq^2 of the port's
  attention FLOPs (its ``kernel.flash_attention`` rows), and nothing
  else.
* The counter's rules on small real tensors: 2 numel(out) K for each dot
  operator, views and ``empty`` counted as no bytes, ``embedding`` reading
  its rows, ``copy_`` not reading its destination, composites under
  ``inference_mode`` decomposed.
"""
import contextlib
import dataclasses

import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import roofline as J_roof
from repro.launch import steps as J_steps
from repro.models import api as J_api
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun, roofline
from repro_torch.models import api


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", sorted(api.SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_flops_equal_jax(name, shape):
    for mode in ("train", "prefill", "decode"):
        assert roofline.model_flops(ARCHS[name], api.SHAPES[shape], mode) \
            == J_roof.model_flops(J_ARCHS[name], J_api.SHAPES[shape], mode)


STATS = [dict(flops=3.1e15, memory_bytes=2.2e12, collective_bytes=4.5e9,
              collective_ops={"all-gather": 21, "all-to-all": 14}),
         dict(flops=1.0e9, memory_bytes=9.9e12, collective_bytes=0.0,
              collective_ops={}),
         dict(flops=2.0e12, memory_bytes=1.0e9, collective_bytes=7.7e12,
              collective_ops={"all-reduce": 3})]


@pytest.mark.parametrize("case", range(len(STATS)))
@pytest.mark.parametrize("n_dev", [1, 256])
def test_roofline_terms_equal_jax_at_jax_constants(case, n_dev, monkeypatch):
    for port, jax_name in (("PEAK_FLOPS", "PEAK_FLOPS"), ("HBM_BW", "HBM_BW"),
                           ("LINK_BW", "ICI_BW")):
        monkeypatch.setattr(roofline, port, getattr(J_roof, jax_name))
    want = J_roof.roofline_terms(J_roof.HloStats(**STATS[case]), n_dev)
    got = roofline.roofline_terms(roofline.StepStats(**STATS[case]), n_dev)
    assert got == want


def test_constants_are_the_h100_data_sheet():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.FP32_FLOPS == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.HBM_BYTES == 80e9
    assert roofline.LINK_BW == 900e9 / 2
    s = roofline.StepStats(flops=67e12, memory_bytes=0.0)
    assert roofline.roofline_terms(s, 1)["compute_s"] == 67 / 989
    assert roofline.roofline_terms(s, 1, roofline.FP32_FLOPS)[
        "compute_s"] == 1.0


def _jax_prefill_flops(t: int) -> float:
    cfg = J_ARCHS["qwen3-32b"].reduced()
    shape = J_api.ShapeSpec("prefill", t, 2, "prefill")
    params = J_steps.abstract_state(cfg)
    batch = J_steps.abstract_batch(cfg, shape, "prefill")
    comp = jax.jit(J_steps.make_prefill_step(cfg)).lower(params,
                                                          batch).compile()
    return J_roof.analyze_hlo(comp.as_text()).flops


@pytest.mark.parametrize("t", [64, 4096])
def test_prefill_dot_flops_equal_jax_analyze_hlo(t):
    cfg = ARCHS["qwen3-32b"].reduced()
    counter = dryrun.count_unsharded(cfg, api.ShapeSpec("prefill", t, 2,
                                                        "prefill"), "prefill")
    got = counter.stats().flops
    want = _jax_prefill_flops(t)
    attn = sum(r.flops for r in counter.records
               if r.op == "kernel.flash_attention")
    block = 2048                        # JAX's SDPA_BLOCK, taken from 2,048
    nq = t // block if t >= block else 1
    masked = ((nq * nq - nq * (nq + 1) // 2) / (nq * nq)) if t >= block else 0
    assert attn > 0
    assert got - want == masked * attn
    assert (got == want) == (t < block)


def _dots(counter):
    return [(r.op, r.flops) for r in counter.records if r.flops]


def test_counter_dot_flops_and_bytes_on_small_tensors():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    x, y = torch.randn(2, 3, 4), torch.randn(2, 4, 6)
    with roofline.StepCounter() as c:
        a @ b                                    # mm
        torch.bmm(x, y)
        torch.addmm(torch.zeros(7), a, b)
        torch.einsum("bij,bjk->bik", x, y)       # bmm after decomposition
        a.view(15).view(5, 3).t()                # views: no bytes
        torch.empty(1000)
    dots = _dots(c)
    assert dots == [("aten.mm", 2 * 3 * 7 * 5), ("aten.bmm", 2 * 2 * 3 * 6 * 4),
                    ("aten.addmm", 2 * 3 * 7 * 5),
                    ("aten.bmm", 2 * 2 * 3 * 6 * 4)]
    mm = next(r for r in c.records if r.op == "aten.mm")
    assert mm.bytes == 4 * (15 + 35 + 21) and mm.dtype == "f32"
    assert mm.path == "?" and mm.shapes == "f32[3,5], f32[5,7] -> f32[3,7]"
    views = [r for r in c.records if r.op in ("aten.t", "aten.view",
                                              "aten.empty")]
    assert views and all(r.bytes == 0 for r in views)
    assert c.stats().flops == sum(f for _, f in dots)


def test_counter_embedding_copy_and_inference_mode():
    table = torch.randn(1000, 16)
    idx = torch.tensor([[1, 2, 3]])
    dst, src = torch.empty(4, 16), torch.randn(4, 16)
    with roofline.StepCounter() as c:
        torch.nn.functional.embedding(idx, table)
        dst.copy_(src)
        with torch.inference_mode():
            torch.matmul(src, table.t())
    emb = next(r for r in c.records if r.op == "aten.embedding")
    assert emb.bytes == 3 * 16 * 4 + 3 * 8 + 3 * 16 * 4   # rows, ids, out
    cp = next(r for r in c.records if r.op == "aten.copy_")
    assert cp.bytes == 2 * 4 * 16 * 4                    # src read, dst out
    assert ("aten.mm", 2 * 4 * 1000 * 16) in _dots(c)


def test_flops_by_dtype_splits_the_matmuls():
    with roofline.StepCounter() as c:
        torch.randn(2, 3) @ torch.randn(3, 4)
        torch.randn(2, 3, dtype=torch.bfloat16) @ torch.randn(
            3, 4, dtype=torch.bfloat16)
    assert roofline.flops_by_dtype(c.records) == {"f32": 48.0, "bf16": 48.0}


@pytest.mark.parametrize("part", ["grads", "prefill"])
def test_count_unsharded_parts_run_on_fake_tensors(part):
    """Each part counts at a reduced config and a shape whose activations
    would not fit this process's memory if they were real (64 x 8,192
    tokens: the prefill's float32 scores alone are 68.7 GB). The
    projections, the MLP and the lm head are 2-D products (``mm``), 2 N
    FLOPs a token forward and 6 N to train (forward, the activations'
    gradient and the weights'; no remat), N the weights that are matrices
    in a layer (the stack's leading dimension aside) but the embedding
    table; attention's are batched (``bmm``), or in serving the flash
    kernel's, one ``kernel.flash_attention`` row a layer."""
    cfg = dataclasses.replace(ARCHS["qwen3-32b"].reduced(), remat=False)
    kind = {"grads": "train"}.get(part, part)
    shape = api.ShapeSpec(part, 8192, 64, kind)
    c = dryrun.count_unsharded(cfg, shape, part)
    s = c.stats()
    assert s.memory_bytes > 0 and s.collective_bytes == 0
    params = dryrun.steps.abstract_state(cfg)
    n = sum(p.numel() for path, p in dryrun.T.leaves_with_paths(params)
            if p.ndim - path.startswith("layers/") >= 2
            and path != "embed_tokens")
    tokens = shape.global_batch * shape.seq_len
    per_token = 6 if kind == "train" else 2
    mm = sum(r.flops for r in c.records if r.op == "aten.mm")
    attn = sum(r.flops for r in c.records if r.op in (
        "aten.bmm", "kernel.flash_attention"))
    assert mm == per_token * n * tokens
    assert attn > 0 and s.flops == mm + attn
    # serving runs the flash kernel's plain version, counted as the kernel
    kernels = [r for r in c.records if r.op.startswith("kernel.")]
    assert len(kernels) == (0 if kind == "train" else cfg.n_layers)
    assert all(r.path == "models/attention.py:gqa_forward"
               for r in kernels)


def test_plain_versions_count_as_their_kernels():
    """A kernel's plain version is one ``kernel.<name>`` row: its operands
    read once, its outputs written once (the (T, S) scores stay on chip),
    its dot FLOPs the plain version's, 2 B H T S (D + Dv) for the full
    square; without a counter the wrapper is the plain version."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_gqa_torch)
    g = torch.Generator().manual_seed(0)
    b, t, h, hkv, d = 2, 40, 4, 2, 16
    q = torch.randn(b, t, h, d, generator=g)
    k, v = (torch.randn(b, t, hkv, d, generator=g) for _ in range(2))
    with roofline.StepCounter() as c:
        out = ops.flash_attention_gqa(q, k, v, 0.25, causal=True)
    assert torch.equal(out, flash_attention_gqa_torch(q, k, v, 0.25, True))
    (row,) = c.records
    assert row.op == "kernel.flash_attention" and row.path == "?"
    assert row.bytes == 4 * (2 * q.numel() + 2 * k.numel())
    assert row.flops == 2 * b * h * t * t * (d + d) and row.dtype == "f32"
    assert torch.equal(ops.flash_attention_gqa(q, k, v, 0.25, causal=True),
                       out)


def test_scan_forward_and_backward_count_as_their_kernels():
    c = dryrun.count_unsharded(ARCHS["hymba-1.5b"].reduced(),
                               api.ShapeSpec("grads", 32, 2, "train"),
                               "grads")
    ops = [r.op for r in c.records if r.op.startswith("kernel.")]
    n = ARCHS["hymba-1.5b"].reduced().n_layers
    # the forward, its remat recompute and the backward, a layer each
    assert ops.count("kernel.ssm_scan") == 2 * n
    assert ops.count("kernel.ssm_scan_bwd") == n
    bwd = next(r for r in c.records if r.op == "kernel.ssm_scan_bwd")
    assert "[SSMScanBackward]" in bwd.path


def _scan_rows(fake: bool):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.ssm_scan import ops
    b, t, d, n = 2, 7, 5, 3
    shapes = [(b, t, d), (b, t, 1), (b, t, n), (b, t, n), (d, n), (b, d, n)]
    with FakeTensorMode() if fake else contextlib.nullcontext():
        g = None if fake else torch.Generator().manual_seed(1)
        xs = [torch.rand(s, generator=g) for s in shapes]
        with roofline.StepCounter() as c:
            leaves = [x.requires_grad_() for x in xs]
            y, s = ops.ssm_chunk_scan(*leaves)
            torch.autograd.grad(y.sum() + s.sum(), leaves)
            with torch.no_grad():
                ops.ssm_chunk_scan(*xs[:5], xs[5].detach().clone(),
                                   s_out=xs[5].detach().clone())
    return [(r.op, r.shapes, r.flops, r.bytes) for r in c.records
            if r.op.startswith("kernel.")]


def test_scan_rows_on_fake_tensors_equal_the_plain_versions():
    """On fake tensors the scan's wrappers skip the plain versions' loop
    over T and give ``scan_flops``: the rows (shapes, FLOPs, bytes) equal
    those of the plain versions run on real tensors of the same shapes."""
    real = _scan_rows(fake=False)
    assert [r[0] for r in real] == ["kernel.ssm_scan", "kernel.ssm_scan_bwd",
                                    "kernel.ssm_scan"]
    assert real[0][2] == 2 * 2 * 7 * 5 * 3 and real[1][2] == 3 * real[0][2]
    assert _scan_rows(fake=True) == real
