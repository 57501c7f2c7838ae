"""The port imports neither JAX nor the JAX package, and runs on CUDA by
default: with no card and no ``device="cpu"`` it raises."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED = r"""
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
for name in sys.argv[2:]:
    assert name in names, name
print(len(names))
"""

# the modules of the solve's kernels, which must be among those imported
_SOLVE_PATH = ("repro_torch.kernels.minplus.levelfold",
               "repro_torch.kernels.minplus.minplus",
               "repro_torch.kernels.minplus.color",
               "repro_torch.kernels.minplus.ops")

# the modules of the reduce path, which must be among those imported
_REDUCE_PATH = ("repro_torch.core.reduce", "repro_torch.core.baselines",
                "repro_torch.collectives", "repro_torch.collectives.topology",
                "repro_torch.collectives.schedule",
                "repro_torch.collectives.tree_allreduce",
                "repro_torch.kernels.segment_reduce",
                "repro_torch.kernels.segment_reduce.ref",
                "repro_torch.kernels.segment_reduce.segment_reduce",
                "repro_torch.kernels.segment_reduce.ops")

# the modules of the training path, which must be among those imported
_TRAIN_PATH = ("repro_torch.tree", "repro_torch.kernels.topk_compress",
               "repro_torch.kernels.topk_compress.ref",
               "repro_torch.kernels.topk_compress.topk_compress",
               "repro_torch.kernels.topk_compress.ops",
               "repro_torch.optim", "repro_torch.optim.adamw",
               "repro_torch.optim.compression", "repro_torch.configs",
               "repro_torch.configs.qwen3_32b", "repro_torch.models",
               "repro_torch.models.config", "repro_torch.models.layers",
               "repro_torch.models.attention",
               "repro_torch.models.transformer", "repro_torch.models.api",
               "repro_torch.data", "repro_torch.data.pipeline",
               "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
               "repro_torch.launch", "repro_torch.launch.train")

# the modules of the serving path, which must be among those imported
_SERVE_PATH = ("repro_torch.kernels.flash_attention",
               "repro_torch.kernels.flash_attention.ref",
               "repro_torch.kernels.flash_attention.flash_attention",
               "repro_torch.kernels.flash_attention.ops",
               "repro_torch.launch.steps")

# the modules of the hybrid family's serving path
_HYBRID_PATH = ("repro_torch.kernels.ssm_scan",
                "repro_torch.kernels.ssm_scan.ref",
                "repro_torch.kernels.ssm_scan.ssm_scan",
                "repro_torch.kernels.ssm_scan.ops", "repro_torch.models.ssm",
                "repro_torch.configs.hymba_1_5b")

# the modules of xLSTM (mLSTM and sLSTM in models.ssm) and of training
# the hybrid and xLSTM families (the backward scan in the scan's modules)
_SSM_PATH = ("repro_torch.configs.xlstm_125m", "repro_torch.models.ssm",
             "repro_torch.kernels.ssm_scan.ops",
             "repro_torch.kernels.ssm_scan.ref",
             "repro_torch.kernels.ssm_scan.ssm_scan")

# the modules of the congestion/fleet penalty loop
_FLEET_PATH = ("repro_torch.core.congestion", "repro_torch.engine.congestion",
               "repro_torch.collectives.schedule")

# the modules of the runtime and its chaos harness
_RUNTIME_PATH = ("repro_torch.runtime", "repro_torch.runtime.orchestrator",
                 "repro_torch.runtime.stragglers",
                 "repro_torch.runtime.elastic", "repro_torch.runtime.faults")

# the rank executor's mesh (reduce_local lives in the reduce path's
# collectives.tree_allreduce)
_DIST_PATH = ("repro_torch.launch.mesh",)

# the MoE layer and the config the card serves through it
_MOE_PATH = ("repro_torch.models.moe", "repro_torch.configs.kimi_k2_1t_a32b",
             "repro_torch.configs.deepseek_v2_236b")

# the encoder-decoder and the configs of the two families it and the VLM
# prefix serve
_ENCDEC_PATH = ("repro_torch.models.encdec",
                "repro_torch.configs.whisper_large_v3",
                "repro_torch.configs.llava_next_34b")

# sharding, the expert-parallel collectives and the sharded step
_SHARD_PATH = ("repro_torch.parallel", "repro_torch.parallel.sharding",
               "repro_torch.parallel.layer_gather",
               "repro_torch.collectives.axis_ops",
               "repro_torch.launch.sharded")

# the dry run, the roofline, the op breakdown, and the kernels' plain
# versions as the counter sees them
_DRYRUN_PATH = ("repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                "repro_torch.launch.profile_ops", "repro_torch.kernels.plain")

# the rest of the numpy core
_CORE_REST = ("repro_torch.core.soar_fast", "repro_torch.core.brute",
              "repro_torch.core.bottleneck", "repro_torch.core.budget",
              "repro_torch.core.online", "repro_torch.core.bytes_model")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(ROOT / "chip_smoke.py"),
         *_SOLVE_PATH, *_REDUCE_PATH, *_TRAIN_PATH, *_SERVE_PATH,
         *_HYBRID_PATH, *_FLEET_PATH, *_RUNTIME_PATH, *_CORE_REST,
         *_DIST_PATH, *_SSM_PATH, *_MOE_PATH, *_ENCDEC_PATH, *_SHARD_PATH,
         *_DRYRUN_PATH],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == 92     # every module imported


def test_default_device_is_cuda_and_raises_without_a_card():
    from repro_torch.core import bt, sample_load
    from repro_torch.engine import EngineOptions, solve_batch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device runs")
    assert EngineOptions().device == "cuda"
    t = bt(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_batch([t], [sample_load(t)], 2)
    res = solve_batch([t], [sample_load(t)], 2,
                      options=EngineOptions(device="cpu"))
    assert np.isfinite(res.costs).all()
    from repro_torch.collectives import chip_level_tree, plan
    topo = chip_level_tree(1, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(topo, 1)
    assert plan(topo, 1, options=EngineOptions(device="cpu")).blue.sum() == 1
    from repro_torch.runtime import Orchestrator, OrchestratorConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Orchestrator(topo, OrchestratorConfig(k=1))
    # a baseline strategy runs on the host and takes no engine options
    top = Orchestrator(topo, OrchestratorConfig(k=1, strategy="top"))
    assert top.blue.sum() == 1
    # the chaos trainer trains on the orchestrator's engine device: the
    # card, when it was built without options
    from repro_torch.runtime import ChaosTrainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChaosTrainer(top)
    cpu = Orchestrator(topo, OrchestratorConfig(k=1, strategy="top"),
                       options=EngineOptions(device="cpu"))
    assert ChaosTrainer(cpu).device == torch.device("cpu")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
