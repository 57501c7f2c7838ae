"""The port's op breakdown (``repro_torch.launch.profile_ops``), the twin
of the JAX package's ``launch/profile_hlo.py``.

* ``op_breakdown``'s memory, collective and dot rows, and its memory by
  operator kind, sum to the same step's ``StepStats`` exactly (one
  process's steps of reduced configs of four families; the sharded cells'
  collectives are held in ``tests/test_torch_dryrun.py``).
* ``report`` prints JAX's sections, its totals the stats'.
* ``main`` runs a production cell (qwen3-32b's ``decode_32k`` on the (16,
  16) mesh of 256 fake ranks) in a subprocess, since its fake process
  group must not stay in an xdist worker, and prints the sections with the
  parameters' all-gathers among the collectives.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun, profile_ops
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ("TOTAL mem=", "-- memory by op kind --", "-- top 5 memory ops --",
            "-- collectives --", "-- top 5 dot ops --")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count(name, part):
    kind = {"grads": "train"}.get(part, part)
    return dryrun.count_unsharded(ARCHS[name].reduced(),
                                  api.ShapeSpec(part, 32, 2, kind), part)


@pytest.mark.parametrize("part", ["grads", "prefill"])
@pytest.mark.parametrize("name", ["qwen3-32b", "deepseek-v2-236b",
                                  "hymba-1.5b", "whisper-large-v3"])
def test_rows_sum_to_the_step_stats(name, part):
    c = _count(name, part)
    mem, coll, flop, by_kind = profile_ops.op_breakdown(c.records)
    s = c.stats()
    assert sum(r[0] for r in mem) == s.memory_bytes == sum(by_kind.values())
    assert sum(r[0] for r in flop) == s.flops > 0
    assert sum(r[0] for r in coll) == s.collective_bytes == 0
    assert all(r[2].startswith(("aten.", "kernel.")) and " -> " in r[3]
               for r in mem + flop)
    # every row names where it ran: a module of the port and its function
    assert all(r[1] != "?" for r in flop)


def test_report_prints_the_sections_with_the_stats_totals(capsys):
    c = _count("qwen3-32b", "grads")
    profile_ops.report(c.records, top=5)
    out = capsys.readouterr().out
    for section in SECTIONS:
        assert section in out
    s = c.stats()
    assert (f"TOTAL mem={s.memory_bytes/1e9:.2f} GB  coll=0.000 GB  "
            f"flops={s.flops/1e12:.3f} T (per device)") in out
    assert "[models/" in out              # rows name their module


def test_main_runs_a_production_cell_on_fake_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.profile_ops", "--arch",
         "qwen3-32b", "--shape", "decode_32k", "--mesh", "single", "--top",
         "5"], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert out.startswith("[qwen3-32b x decode_32k x single] setup=")
    for section in SECTIONS:
        assert section in out
    coll = out.split("-- collectives --")[1].split("-- top")[0]
    assert coll.split()[0] == "all-gather"
    # the parameters gathered a layer at a time
    assert "[parallel/layer_gather.py:" in coll
