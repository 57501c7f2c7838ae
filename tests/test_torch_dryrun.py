"""The port's dry run (``repro_torch.launch.dryrun``) vs the JAX package's
``launch/dryrun.py``.

The port's cells run on a fake process group, which must not stay the
default group of an xdist worker (the gloo files that run after it would
find it), so they run in subprocesses: this file run as ``--port OUT
train|serve``. JAX's run in three more (``--jax OUT
train0|train1|serve``, 8 host devices, a directly built
``jax.sharding.Mesh``: ROADMAP C4's workaround), exactly as its
``lower_cell`` does. The five start together for the module.

* Every config, reduced, x train, prefill and decode (32 tokens, batch 8)
  on a fake (2, 4) mesh runs ``ok``.
* Its per-device argument bytes equal JAX's
  ``memory_analysis().argument_size_in_bytes`` of the same cell, less the
  differences derived leaf by leaf (no dimension fails to divide at these
  sizes, so JAX pads none):
  - token ids are int64 in the port (its data pipeline makes them) and
    int32 in JAX: 4 bytes more a local id (``tokens``, ``labels``);
  - decode: JAX's token is a replicated (B, 1) int32 and ``pos`` a ()
    int32 argument; the port's token is this rank's (B / dp, 1) rows and
    ``pos`` a host int: 4 (B - B / dp) + 4 bytes fewer in the port, 4
    (B - B / dp) for xLSTM, whose decode reads no position (``jit`` drops
    the arguments a step never reads: ``keep_unused=False``);
  - whisper's decode never reads the encoder's parameters and the cross
    attention's key and value projections (a decode step reads the cross
    caches instead), which the port's step is handed: their local bytes
    more in the port.
* The counter's rows (``profile_ops.op_breakdown``) sum to each cell's
  ``StepStats``, and its collective bytes equal the operand bytes that
  ``axis_ops.exchange_log`` recorded.
* ``long_500k`` on a full-attention config is ``skipped`` with JAX's
  reason; a planted spec that does not divide gives ``error`` (and
  ``main`` exits naming the cell), not a crash.
* One full-size cell, qwen3-32b's ``decode_32k`` on the (16, 16) mesh of
  256 fake ranks: ``ok``, its argument bytes this rank's shards (reckoned
  here from the specs), its peak within the card and far below the whole
  parameters (the serve step gathers a layer at a time).
* The dense configs' training dot FLOPs a device are JAX's plus the k/v
  projections of the KV head a rank's query heads read (``_kv_term``),
  and each reduced train cell's peak stays within its layer-gather
  reckoning, itself below the whole-gather one.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import api as J_api
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun, steps
from repro_torch.models import api
from repro_torch.parallel.sharding import PartitionSpec

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"train": api.ShapeSpec("train_4k", 32, 8, "train"),
          "prefill": api.ShapeSpec("prefill_32k", 32, 8, "prefill"),
          "decode": api.ShapeSpec("decode_32k", 32, 8, "decode")}
CELLS = [(name, kind) for name in sorted(ARCHS) for kind in SHAPES]
MESH = {"data": 2, "model": 4}
FULL = ("qwen3-32b", "decode_32k")
# JAX's cells in three processes (its training cells compile longest)
_TRAIN = [c for c in CELLS if c[1] == "train"]
_SERVE = [c for c in CELLS if c[1] != "train"]
JAX_SPLIT = {"train0": _TRAIN[:5], "train1": _TRAIN[5:], "serve": _SERVE}


class StandInMesh:
    """A mesh's axis names and sizes, as the spec functions read them."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = np.empty(tuple(sizes.values()), dtype=np.int8)


def _local_bytes(tree, specs, sizes: dict) -> dict:
    """path -> bytes of this rank's shard of each leaf under ``specs``."""
    out = {}
    flat = dict(T.leaves_with_paths(tree))
    steps.map_with_path(lambda p, s: out.__setitem__(p, s), specs)
    got = {}
    for path, leaf in flat.items():
        split = 1
        for entry in out[path]:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                split *= sizes[ax] if ax else 1
        got[path] = leaf.numel() // split * leaf.element_size()
    return got


# -- the subprocesses ---------------------------------------------------------

def _port_main(out: str, which: str) -> None:
    from repro_torch.launch import profile_ops
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    res = {}
    for name, kind in (_TRAIN if which == "train" else _SERVE):
        with dryrun.fake_world(8):
            run = dryrun.run_cell_fake(ARCHS[name].reduced(), SHAPES[kind],
                                       make_test_mesh(*MESH.values()))
        mem, coll, flop, _ = profile_ops.op_breakdown(run.records)
        s = run.stats
        res[f"{name}/{kind}"] = {
            "args": run.memory["argument_bytes"],
            "peak": run.memory["peak_bytes"],
            "totals": [sum(r[0] for r in mem) == s.memory_bytes,
                       sum(r[0] for r in coll) == s.collective_bytes,
                       sum(r[0] for r in flop) == s.flops],
            "collective_bytes": s.collective_bytes,
            "logged_operand_bytes": sum(e["operand_bytes"]
                                        for e in run.exchanges),
            "flops": s.flops}
    if which == "train":
        Path(out).write_text(json.dumps(res))
        return
    dryrun.OUT_DIR = Path(tempfile.mkdtemp())
    res["full"] = dryrun.run_cell(*FULL, "single")
    real = steps.param_pspecs

    def planted(params, rules):     # 128-wide q norms over 256 ranks
        return steps.map_with_path(
            lambda p, s: PartitionSpec(None, ("data", "model"))
            if p.endswith("q_norm") else s, real(params, rules))

    steps.param_pspecs = planted
    res["planted"] = dryrun.run_cell(*FULL, "single", force=True)
    try:
        dryrun.main(["--arch", FULL[0], "--shape", FULL[1], "--mesh",
                     "single", "--force"])
        res["main_exit"] = None
    except SystemExit as e:
        res["main_exit"] = str(e.code)
    Path(out).write_text(json.dumps(res))


def _jax_main(out: str, which: str) -> None:
    import jax
    assert len(jax.devices()) == 8
    from repro.launch import dryrun as J_dryrun
    from repro.launch import roofline as J_roof
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                             ("data", "model"))
    res = {}
    for name, kind in JAX_SPLIT[which]:
        s = SHAPES[kind]
        shape = J_api.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)
        _, comp, _ = J_dryrun.lower_cell(J_ARCHS[name].reduced(), shape,
                                         mesh)
        res[f"{name}/{kind}"] = {
            "args": comp.memory_analysis().argument_size_in_bytes,
            "flops": J_roof.analyze_hlo(comp.as_text()).flops}
    Path(out).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        parts = [("--port", "train"), ("--port", "serve"),
                 *(("--jax", k) for k in JAX_SPLIT)]
        outs = {r: os.path.join(tmp, f"{r[0][2:]}-{r[1]}.json")
                for r in parts}
        procs = {r: subprocess.Popen(
            [sys.executable, __file__, r[0], outs[r], r[1]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=tmp) for r in parts}
        for k, p in procs.items():
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"{k}: {err[-3000:]}"
        got = {k: json.loads(Path(o).read_text()) for k, o in outs.items()}
    merged = {side: {k: v for r, part in got.items() if r[0] == side
                     for k, v in part.items()}
              for side in ("--port", "--jax")}
    return merged["--port"], merged["--jax"]


def _derived_gap(name: str, kind: str) -> int:
    """The port's argument bytes less JAX's, leaf by leaf."""
    cfg, shape = ARCHS[name].reduced(), SHAPES[kind]
    mesh = StandInMesh(MESH)
    rules = steps.rules_for(mesh, shape)
    dp = MESH["data"]
    if kind == "decode":
        rows = shape.global_batch // dp
        # xLSTM's decode (recurrent states, no positions) never reads pos
        gap = -(4 * (shape.global_batch - rows)
                + 4 * (cfg.family != "ssm"))
        if cfg.is_encoder_decoder:
            params = steps.abstract_state(cfg)
            local = _local_bytes(params, steps.param_pspecs(params, rules),
                                 MESH)
            gap += sum(b for p, b in local.items() if p.startswith("enc")
                       or p in ("dec_layers/cross/w_k",
                                "dec_layers/cross/w_v"))
        return gap
    batch = steps.abstract_batch(cfg, shape, kind)
    return sum(4 * t.numel() // dp for t in batch.values()
               if t.dtype == torch.int64)


@pytest.mark.parametrize("name,kind", CELLS)
def test_reduced_cell_runs_and_its_argument_bytes_are_jax(runs, name, kind):
    port, jax_ = runs
    got, want = port[f"{name}/{kind}"], jax_[f"{name}/{kind}"]
    assert got["args"] - want["args"] == _derived_gap(name, kind)


@pytest.mark.parametrize("name,kind", CELLS)
def test_rows_sum_to_the_stats_and_to_the_exchange_log(runs, name, kind):
    got = runs[0][f"{name}/{kind}"]
    assert got["totals"] == [True, True, True]
    assert got["collective_bytes"] == got["logged_operand_bytes"] > 0


DENSE = ("qwen3-32b", "granite-20b", "nemotron-4-340b", "llava-next-34b")


def _kv_term(name: str) -> int:
    """The port's training dot FLOPs a device beyond JAX's: the k and v
    projections. Where ``model`` does not divide the KV heads (2 or 1 of
    them over 4 ranks here), JAX's partitioned step splits their
    ``Hkv * hd`` columns over ``model`` and a rank computes ``Hkv hd / m``
    of them; the port's rank computes the one KV head its query heads read
    (``hd`` columns). Each of the two products is counted four times a
    layer (the forward, remat's recompute, and the backward's two
    products), 2 N d flops a column each: 16 L N d (hd - Hkv hd / m), N
    a rank's tokens."""
    cfg, shape = ARCHS[name].reduced(), SHAPES["train"]
    m = MESH["model"]
    if cfg.n_kv_heads % m == 0:
        return 0
    n = shape.global_batch // MESH["data"] * shape.seq_len
    cols = cfg.hd - cfg.n_kv_heads * cfg.hd // m
    return 16 * cfg.n_layers * n * cfg.d_model * cols


def test_dense_training_dot_flops_are_jax_and_the_kv_heads(runs):
    """With the heads, the MLP width and the vocabulary split over
    ``model`` (``parallel.layer_gather``), the dense configs' training dot
    FLOPs a device equal JAX's partitioned step's plus ``_kv_term``, the
    k/v projections of the KV head a rank's query heads read (the
    embedding lookup has no dot)."""
    port, jax_ = runs
    for name in DENSE:
        key = f"{name}/train"
        assert port[key]["flops"] == jax_[key]["flops"] + _kv_term(name), \
            (key, port[key]["flops"], jax_[key]["flops"], _kv_term(name))
        assert _kv_term(name) > 0


def _train_reckoning(name: str, args: int, tp: bool) -> int:
    """Bytes reckoned for one rank of the reduced train cell (bfloat16
    parameters, float32 moments, remat), with the layer gather and tensor
    parallelism (``tp``) or with every leaf gathered whole (the step before
    the layer gather): ``args`` (its shards, moments and batch block); the
    gathered parameters and their whole gradients, one layer and the
    largest leaf outside the layers (``tp``) or the whole model; the remat
    boundaries, L N d bfloat16; the logits over a rank's vocabulary
    columns, bfloat16 and three float32 copies (the cast, its exp and the
    gradient); and one layer's activations and their gradients (twice):
    six float32 (N, d) tensors of the norms and residual sums, q, k and v
    in bfloat16 and in float32 (rope), three float32 (N, ff) of the MLP and
    three float32 score tensors (B, H, T, T), at a rank's widths."""
    cfg, shape = ARCHS[name].reduced(), SHAPES["train"]
    m, b = MESH["model"], 2
    rows, t = shape.global_batch // MESH["data"], shape.seq_len
    n, d = rows * t, cfg.d_model
    params = steps.abstract_state(cfg)
    nb = lambda x: x.numel() * x.element_size()
    flat = dict(T.leaves_with_paths(params))
    whole = sum(nb(x) for x in flat.values())
    if tp:
        layer = sum(nb(x) // x.shape[0] for p, x in flat.items()
                    if p.startswith("layers/"))
        rest = max(nb(x) for p, x in flat.items()
                   if not p.startswith("layers/"))
        heads = cfg.n_heads // m
        kv = (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else 1)
        ff, vocab = cfg.d_ff // m, cfg.padded_vocab // m
    else:
        layer, rest = whole, 0
        heads, kv, ff, vocab = (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                                cfg.padded_vocab)
    acts = (n * (6 * d * 4 + (heads + 2 * kv) * cfg.hd * (b + 4)
                 + 3 * ff * 4) + 3 * rows * heads * t * t * 4)
    return (args + 2 * (layer + rest) + cfg.n_layers * n * d * b
            + n * vocab * (b + 3 * 4) + 2 * acts)


@pytest.mark.parametrize("name", DENSE)
def test_reduced_train_peak_within_its_reckoning(runs, name):
    """A rank's peak (MemTracker's, counts from shapes) of the reduced
    train cell stays within the layer-gather reckoning, which lies below
    the whole-gather reckoning."""
    got = runs[0][f"{name}/train"]
    mine = _train_reckoning(name, got["args"], tp=True)
    assert got["peak"] <= mine < _train_reckoning(name, got["args"],
                                                  tp=False), \
        (got["peak"], mine)


def test_full_size_cell_on_256_fake_ranks(runs):
    rec = runs[0]["full"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256
    cfg, shape = ARCHS[FULL[0]], api.SHAPES[FULL[1]]
    mesh = StandInMesh({"data": 16, "model": 16})
    rules = steps.rules_for(mesh, shape)
    params, caches = steps.abstract_state(cfg), steps.abstract_caches(cfg,
                                                                      shape)
    want = (sum(_local_bytes(params, steps.param_pspecs(params, rules),
                             {"data": 16, "model": 16}).values())
            + sum(_local_bytes(caches, steps.cache_pspecs(caches, mesh, shape),
                               {"data": 16, "model": 16}).values())
            + 4 * shape.global_batch // 16)
    mem = rec["memory"]
    assert mem["argument_bytes"] == want
    whole = sum(p.numel() * p.element_size() for p in T.leaves(params))
    # a layer at a time: far below the whole parameters, within the card
    assert whole > 60e9 and mem["peak_bytes"] < 0.2 * whole
    assert mem["fits"] is True
    r = rec["roofline"]
    assert r["bottleneck"] == "memory" and r["flops_global"] == 256 * r[
        "flops_per_device"]
    assert math.isclose(rec["useful_flops_ratio"],
                        rec["model_flops"] / r["flops_global"])
    # the layers' gathers; the embedding's and head's rows travel over dp
    # (a decode step's tokens are fewer than d_model), one all-to-all each
    assert {e["op"] for e in rec["exchanges"]} == {"all_gather",
                                                  "all_to_all"}


def test_planted_spec_gives_error_and_main_names_the_cell(runs):
    port = runs[0]
    rec = port["planted"]
    assert rec["status"] == "error"
    assert "does not split over 16 ranks" in rec["error"]
    assert "traceback" in rec
    assert port["main_exit"] == f"1 cells failed: [{FULL + ('single',)}]"


def test_long_context_on_full_attention_is_skipped_with_jax_reason(
        tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    rec = dryrun.run_cell("qwen3-32b", "long_500k", "multi")
    want = J_api.cell_supported(J_ARCHS["qwen3-32b"],
                                J_api.SHAPES["long_500k"])
    assert (rec["status"], rec["reason"]) == ("skipped", want[1])
    assert json.loads((tmp_path / "qwen3-32b__long_500k__multi.json")
                      .read_text()) == rec
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    (_port_main if sys.argv[1] == "--port" else _jax_main)(*sys.argv[2:4])
