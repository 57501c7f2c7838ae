"""Data-parallel training driver with the SOAR gradient reduce: the port of
the JAX package's ``launch/train.py``.

  data/SyntheticLM -> models/api loss -> per-worker gradient -> top-k/int8
  compression with error feedback -> SOAR reduce (tree_allreduce) ->
  optim/adamw -> checkpoint/CheckpointManager

Single-card form (``--n-dev N``): ``n_dev`` data-parallel workers are
simulated on one device, as XLA's fake host devices simulate them for the
JAX driver. Each worker takes the loss and the gradient of its shard of
the global batch and compresses it with its own error feedback; the sent
gradients are stacked ``(n_dev, ...)`` per leaf, reduced with the SOAR
program (every Reduce a segment-reduce launch on the card), scaled by
``grad_scale / n_dev`` and applied by AdamW. Loss and metrics are the mean
over workers. With one worker there is no reduce and no scale, as in JAX.

Distributed form (under ``torchrun`` with ``WORLD_SIZE`` > 1, as the JAX
driver uses ``reduce_local`` when more than one device is visible): one
rank per worker, ``n_dev`` the world size, the data-parallel group taken
from a 1-D ``("data",)`` mesh. Each rank takes its own shard, its own
gradient and error-feedback row, and reduces leaf by leaf with
``reduce_local`` over the group; every rank then applies the same AdamW.
Loss and metrics are gathered and summed in rank order, as the
single-card form sums its workers', so the two forms are bitwise equal
(held on gloo CPU ranks in ``tests/test_torch_dist_train.py``, and on one
card shared by 8 ranks in ``chip_smoke.py``'s phase 14). A rank's device
is ``cuda:LOCAL_RANK`` unless ``--device`` names one; ``--dist-backend``
is ``nccl`` for CUDA and ``gloo`` for the CPU by default. NCCL refuses two
ranks on one card, so ``--device cuda:0`` with several ranks on a host
needs ``--dist-backend gloo`` (its messages staged through host memory).
Every rank builds the same orchestrator and replans on ``--fail``; each
new program's fingerprint is compared across ranks before its first
reduce. Rank 0 prints and writes the checkpoints, with the error feedback
gathered to ``(n_dev, ...)``, the single-card form's layout: either form
resumes from the other's checkpoints.

The program and ``grad_scale`` come from the runtime's
:class:`~repro_torch.runtime.Orchestrator` over ``dp_fleet(n_dev)``, as in
the JAX driver. ``--fail "STEP:DEV,DEV;..."`` fails workers before a step:
the orchestrator replans (its solve on the trainer's device), the step is
rebuilt on the new program and ``grad_scale``, and the dead workers'
batch shards are zeroed; their sent rows are no longer read by the
reduce.

Checkpoints hold params, optimizer state and error feedback, labelled with
the number of steps taken, so a resumed run repeats no step and continues
bit for bit (the JAX driver labels a checkpoint with the step it has just
taken, repeats that step on resume and restarts the error feedback from
zero: ROADMAP C9). For the same reason a resumed run applies the failures
of the steps before its first one before it starts (the JAX driver skips
them).

Usage:
  python -m repro_torch.launch.train --preset-100m --n-dev 8 \
      --compress topk:0.01 --steps 20 --ckpt-dir /tmp/ckpt   # on the card
  python -m repro_torch.launch.train --reduced --device cpu --steps 5 \
      --n-dev 4 --fail "2:0"
  torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \
      --preset-100m --compress topk:0.01           # 8 cards, NCCL
  torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \
      --preset-100m --device cuda:0 --dist-backend gloo    # 8 ranks, 1 card
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from .. import tree as T
from ..checkpoint import ckpt
from ..collectives import chip_level_tree
from ..collectives.tree_allreduce import (Link, check_same_program,
                                          reduce_local, tree_allreduce)
from ..configs import ARCHS
from ..data.pipeline import DataConfig, SyntheticLM
from ..engine import EngineOptions
from ..models import api
from ..models.config import ModelConfig
from ..optim import adamw
from ..optim.compression import (CompressionConfig, compress_leaf,
                                 init_error_feedback, payload_bytes)
from ..runtime import Orchestrator, OrchestratorConfig
from .mesh import make_dp_mesh


def dp_fleet(n_devices: int):
    """A chip-level reduction tree whose leaves are the dp devices."""
    # factor n_devices into pods x racks x chips (powers of two preferred)
    chips = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    rest = n_devices // chips
    pods = 2 if rest % 2 == 0 and rest > 1 else 1
    racks = max(1, rest // pods)
    assert pods * racks * chips == n_devices, (pods, racks, chips, n_devices)
    return chip_level_tree(n_pods=pods, racks_per_pod=racks,
                           chips_per_rack=chips)


def orchestrator(n_dev: int, k: int, strategy: str = "soar",
                 device="cuda") -> Orchestrator:
    """The gradient reduce's :class:`Orchestrator` over ``dp_fleet(n_dev)``,
    as the JAX driver builds it; its SOAR solves run on ``device``."""
    return Orchestrator(dp_fleet(n_dev),
                        OrchestratorConfig(k=k, strategy=strategy),
                        options=EngineOptions(device=str(device)))


def scaled(g: torch.Tensor, scale: float) -> torch.Tensor:
    """``g * scale`` as JAX computes an array times a Python float: the
    weakly typed scalar is first rounded to ``g``'s dtype."""
    return g * torch.tensor(scale, dtype=g.dtype, device=g.device)


class TrainStep:
    """One data-parallel step: per-worker gradients (+ compression), the
    SOAR reduce, AdamW. ``step(params, opt_state, ef, batch)`` returns
    ``(params, opt_state, ef, metrics)``; params, moments and error
    feedback are updated in place. ``batch`` is the global batch.

    Without ``group`` the ``n_dev`` workers are simulated here; for
    ``n_dev > 1`` every ``ef`` leaf is stacked ``(n_dev, ...)``, one row
    per worker. With a process ``group`` of ``n_dev`` ranks this rank is
    worker ``group``'s rank: it takes its shard of the batch, its ``ef``
    leaves are its own row (the parameters' shapes), its gradient is
    reduced with ``reduce_local`` over the group, and loss and metrics are
    every rank's gathered and summed in rank order. Its first call checks
    that every rank holds the same program.

    Pass a dict as ``timings`` to add the seconds of each phase (the
    device synchronised at its edges): ``fwd_bwd``, ``compress``,
    ``reduce``, ``adamw``.
    """

    def __init__(self, cfg: ModelConfig, ocfg: adamw.AdamWConfig, prog,
                 grad_scale: float,
                 ccfg: CompressionConfig = CompressionConfig(), group=None):
        self.cfg, self.ocfg, self.prog, self.ccfg = cfg, ocfg, prog, ccfg
        self.grad_scale = grad_scale
        self.n_dev = prog.n_dev
        self.lfn = api.loss_fn(cfg)
        self.group = group
        self._checked = group is None
        if group is not None:
            if dist.get_world_size(group) != prog.n_dev:
                raise ValueError(f"the group has {dist.get_world_size(group)}"
                                 f" ranks; the program runs on {prog.n_dev} "
                                 f"devices")
            self.rank = dist.get_rank(group)

    @staticmethod
    def _tick(timings, name, t0, device):
        if timings is None:
            return t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + t1 - t0
        return t1

    def worker_grads(self, params, ef, batch, timings=None):
        """Loss, metrics and sent gradient of each worker (of this rank's,
        with a group). Returns ``(loss, metrics, sent)``, loss and metrics
        the mean over workers, ``sent`` a dict path -> stacked ``(n_dev,
        ...)`` gradients (n_dev > 1, simulated), this rank's gradients
        (a group) or the gradient tree's leaves (n_dev = 1)."""
        n = self.n_dev
        stacked = n > 1 and self.group is None
        named = list(T.leaves_with_paths(params))
        leaves = [p for _, p in named]
        ef_flat = dict(T.leaves_with_paths(ef))
        dev = leaves[0].device
        per = next(iter(batch.values())).shape[0] // n
        sent = ({path: torch.empty((n,) + tuple(p.shape), dtype=p.dtype,
                                   device=dev) for path, p in named}
                if stacked else {})
        losses, nlls, auxs = [], [], []
        t0 = time.perf_counter()
        for i in (range(n) if self.group is None else [self.rank]):
            shard = ({k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                     if n > 1 else batch)
            loss, met = self.lfn(params, shard)
            grads = list(torch.autograd.grad(loss, leaves))
            losses.append(loss.detach())
            nlls.append(met["nll"].detach())
            auxs.append(met["aux"].detach())
            t0 = self._tick(timings, "fwd_bwd", t0, dev)
            for j, (path, p) in enumerate(named):
                g, grads[j] = grads[j], None          # free leaf by leaf
                if self.ccfg.kind != "none":
                    e = ef_flat[path][i] if stacked else ef_flat[path]
                    g, resid = compress_leaf(g, e, self.ccfg)
                    e.copy_(resid)
                    del resid
                if stacked:
                    sent[path][i].copy_(g)
                else:
                    sent[path] = g.to(p.dtype) if n > 1 else g
                del g
            t0 = self._tick(timings, "compress", t0, dev)
        if self.group is not None:        # every rank's, in rank order
            link = Link(self.group, dev)
            losses, nlls, auxs = (
                [o.reshape(()) for o in link.all_gather(x[0].reshape(1))]
                for x in (losses, nlls, auxs))
        mean = lambda xs: torch.stack(xs).sum() / n
        return mean(losses), {"nll": mean(nlls), "aux": mean(auxs)}, sent

    def reduce(self, sent: dict, timings=None) -> dict:
        """SOAR-reduce the stacked gradients (this rank's, with a group)
        leaf by leaf, freeing each as it goes, and scale by
        ``grad_scale / n_dev``."""
        n = self.n_dev
        out = {}
        t0 = time.perf_counter()
        for path in list(sent):
            g = sent.pop(path)
            if self.group is None:
                r = tree_allreduce(g.reshape(n, -1), self.prog).reshape(
                    g.shape[1:])
            else:
                r = reduce_local(g, self.prog, self.group)
            out[path] = scaled(r, self.grad_scale / n)
            del g, r
        if out:
            self._tick(timings, "reduce", t0, next(iter(out.values())).device)
        return out

    def __call__(self, params, opt_state, ef, batch, timings=None):
        if not self._checked:
            check_same_program(self.prog, self.group,
                               T.leaves(params)[0].device)
            self._checked = True
        loss, metrics, sent = self.worker_grads(params, ef, batch, timings)
        grads = self.reduce(sent, timings) if self.n_dev > 1 else sent
        grads = T.unflatten(grads, like=params)
        dev = loss.device
        t0 = time.perf_counter()
        params, opt_state, gnorm = adamw.update(grads, opt_state, params,
                                                self.ocfg)
        self._tick(timings, "adamw", t0, dev)
        return params, opt_state, ef, {"loss": loss, "grad_norm": gnorm,
                                       **metrics}


def make_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig, prog,
              grad_scale: float,
              ccfg: CompressionConfig = CompressionConfig(),
              group=None) -> TrainStep:
    """The training step for ``prog.n_dev`` workers (:class:`TrainStep`):
    simulated here, or one a rank of ``group``."""
    return TrainStep(cfg, ocfg, prog, grad_scale, ccfg, group)


def mask_dead_batch(batch, alive, global_batch: int, n_dev: int):
    """Zero the batch shards of non-contributing devices.

    Dead/quarantined chips produce no gradient messages; their slice of
    the global batch is zeroed (a zero contribution to the sum) and the
    orchestrator's ``grad_scale`` re-normalizes the mean over survivors.
    """
    dead = [d for d, a in enumerate(alive) if not a]
    if not dead:
        return batch
    per = global_batch // n_dev
    first = next(iter(batch.values()))
    mask = torch.ones(global_batch, dtype=torch.bool, device=first.device)
    for d in dead:
        mask[d * per:(d + 1) * per] = False
    return {k: torch.where(mask[:, None] if v.ndim > 1 else mask, v, 0)
            for k, v in batch.items()}


def parse_failures(spec: str | None) -> dict[int, list[int]]:
    """--fail "30:0,1;60:5" -> {30: [0, 1], 60: [5]}."""
    out: dict[int, list[int]] = {}
    if not spec:
        return out
    for part in spec.split(";"):
        step_s, devs = part.split(":")
        out[int(step_s)] = [int(d) for d in devs.split(",")]
    return out


def config_from_args(args) -> ModelConfig:
    """The config ``--arch`` names, cut by ``--preset-100m`` or
    ``--reduced``. A VLM trains text-only, as the JAX trainer trains it:
    the data pipeline makes tokens and no image embeddings, so the batch
    holds no ``prefix_embeds`` and ``loss_fn`` takes no prefix. Raises
    ``ValueError`` for the encoder-decoder, whose ``loss_fn`` reads audio
    frames the pipeline does not make; the JAX trainer cannot train it
    either (its ``encdec.loss_fn`` reads ``batch["frames"]``). Training it
    on frames is beyond the JAX package (ROADMAP.md, former item 4b)."""
    cfg = ARCHS[args.arch]
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: the trainer's data pipeline makes "
                         f"tokens only, no audio frames, and the "
                         f"encoder-decoder's loss reads frames (so does the "
                         f"JAX trainer's: encdec.loss_fn reads "
                         f"batch['frames']); training it on frames is beyond "
                         f"the JAX package (ROADMAP.md, former item 4b); it "
                         f"serves through launch.steps")
    if args.preset_100m:
        return cfg.reduced(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                           d_ff=2048, vocab=32_768, head_dim=0)
    if args.reduced:
        return cfg.reduced()
    return cfg


def rank_device(spec: str | None, backend: str | None):
    """``(device, backend)`` of this rank of a distributed run.

    ``spec`` None or ``"cuda"`` is ``cuda:LOCAL_RANK``; ``"cuda:N"`` and
    ``"cpu"`` are taken as given. ``backend`` defaults to ``nccl`` for CUDA
    and ``gloo`` for the CPU. NCCL refuses two ranks on one card, so a
    named card shared by the host's ``LOCAL_WORLD_SIZE`` > 1 ranks under
    NCCL raises; gloo shares it.
    """
    local_rank = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    named = spec not in (None, "cuda")
    device = torch.device(spec if named else f"cuda:{local_rank}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL sends CUDA tensors; --device {spec} "
                             f"needs --dist-backend gloo")
        if named and local_world > 1:
            raise ValueError(
                f"NCCL cannot run two ranks on one card: the {local_world} "
                f"ranks of this host would all run on {device}. Pass "
                f"--dist-backend gloo to share a card (messages staged "
                f"through host memory), or drop --device to give each rank "
                f"cuda:LOCAL_RANK")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to train "
                               "on the CPU")
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"{device} does not exist: "
                               f"{torch.cuda.device_count()} cards visible")
    return device, backend


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--preset-100m", action="store_true",
                    help="~100M-param config for the e2e example")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--k", type=int, default=2, help="SOAR blue budget")
    ap.add_argument("--strategy", default="soar")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail", default=None,
                    help='inject failures, e.g. "30:0;60:2,3" (step:devices)')
    ap.add_argument("--compress", default=None,
                    help='gradient compression: "topk:0.01" | "int8"')
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-dev", type=int, default=None,
                    help="data-parallel workers, simulated on one device "
                         "(default 1); under torchrun absent or the world "
                         "size")
    ap.add_argument("--device", default=None,
                    help='"cuda" (default; under torchrun cuda:LOCAL_RANK),'
                         ' "cuda:N" or "cpu"')
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="under torchrun: nccl for CUDA, gloo for the CPU "
                         "by default")
    args = ap.parse_args(argv)

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world == 1:
        device = torch.device(args.device or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to train "
                               "on the CPU")
        return _train(args, device, args.n_dev or 1, None)
    if args.n_dev not in (None, world):
        raise SystemExit(f"--n-dev {args.n_dev} != the world size {world}")
    device, backend = rank_device(args.device, args.dist_backend)
    if device.type == "cuda":
        # before the mesh, which would set cuda:LOCAL_RANK otherwise
        torch.cuda.set_device(device)
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group(backend)
    try:
        if str(dist.get_backend()) != backend:
            raise SystemExit(f"the process group runs {dist.get_backend()}, "
                             f"not {backend}")
        group = make_dp_mesh(world, device_type=device.type).get_group("data")
        return _train(args, device, world, group)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, device: torch.device, n_dev: int, group) -> list[float]:
    """The run of ``main``: ``n_dev`` workers simulated on ``device``
    (``group`` None) or this rank's worker of ``group``."""
    rank = 0 if group is None else dist.get_rank(group)
    say = print if rank == 0 else (lambda *a, **kw: None)
    cfg = config_from_args(args)
    if device.type == "cpu" and cfg.param_count() > 1e9:
        raise SystemExit("full-size config on CPU driver; pass --reduced")
    say(f"arch={cfg.name} params={cfg.param_count():,}")

    if args.global_batch % n_dev:
        raise SystemExit(f"--global-batch {args.global_batch} does not "
                         f"split over {n_dev} workers")
    orch = orchestrator(n_dev, args.k, args.strategy, device)
    say(f"devices={n_dev} fleet_switches={orch.topo0.tree.n} k={args.k} "
        f"phi={orch.program.utilization:.1f} "
        f"msgs={orch.program.total_network_messages}"
        + ("" if group is None else
           f" ranks={n_dev} backend={dist.get_backend(group)}"))

    ocfg = adamw.AdamWConfig()
    ccfg = CompressionConfig.parse(args.compress)
    params = api.init_fn(cfg, device)(args.seed)
    opt_state = adamw.init(params, ocfg)
    ef = init_error_feedback(params)
    if n_dev > 1 and group is None:
        ef = T.tree_map(lambda e: e.new_zeros((n_dev,) + tuple(e.shape)), ef)
    if ccfg.kind != "none":
        dense_b = payload_bytes(params, CompressionConfig())
        comp_b = payload_bytes(params, ccfg)
        say(f"compression={ccfg.kind} worker payload "
            f"{dense_b/1e6:.1f} MB -> {comp_b/1e6:.2f} MB "
            f"({dense_b/comp_b:.0f}x)")
    data = SyntheticLM(cfg, DataConfig(args.global_batch, args.seq,
                                       seed=args.seed), device=device)

    mgr = ckpt.CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    link = None if group is None else Link(group, device)

    def save(step: int) -> None:
        """Rank 0 writes; with a group the error feedback is gathered to
        the simulated form's ``(n_dev, ...)`` rows first."""
        ef_rows = ef if group is None else T.tree_map(link.gather, ef)
        if rank == 0:
            mgr.save(step, {"params": params, "opt": opt_state,
                            "ef": ef_rows})

    start = 0
    if mgr and args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        ef_like = ef if group is None else T.tree_map(
            lambda e: torch.empty((), dtype=e.dtype).expand(
                (n_dev,) + tuple(e.shape)), ef)
        saved, start = ckpt.restore(
            args.ckpt_dir, {"params": params, "opt": opt_state,
                            "ef": ef_like})
        if group is not None:
            saved["ef"] = T.tree_map(lambda e: e[rank], saved["ef"])
        with torch.no_grad():
            for dst, src in zip(T.leaves({"params": params, "opt": opt_state,
                                          "ef": ef}), T.leaves(saved),
                                strict=True):
                dst.copy_(src)
        say(f"resumed from step {start}")

    failures = parse_failures(args.fail)
    for step in sorted(s for s in failures if s < start):
        orch.on_failure(failures[step])       # failed before the checkpoint

    def build():
        kw = {} if group is None else {"group": group}
        return make_step(cfg, ocfg, orch.program, orch.grad_scale, ccfg,
                         **kw)

    step_fn = build()
    losses = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        if step in failures:
            orch.on_failure(failures[step])
            say(f"[step {step}] failure {failures[step]} -> replanned "
                f"phi={orch.program.utilization:.1f} "
                f"alive={orch.n_alive}")
            step_fn = build()
        batch = data.batch(step)
        if n_dev > 1:
            batch = mask_dead_batch(batch, orch.alive, args.global_batch,
                                    n_dev)
        params, opt_state, ef, metrics = step_fn(params, opt_state, ef, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt / max(1, step - start + 1):.2f}s/step)")
        done = step + 1
        if mgr and done < args.steps and done % args.ckpt_every == 0:
            save(done)
    if mgr:
        save(args.steps)
        mgr.wait()
    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
