"""The training step over a device mesh, one rank a device: the port's
twin of the JAX package's ``jit(make_train_step, in_shardings=(named(mesh,
param_pspecs), named(mesh, opt_pspecs), named(mesh, batch_pspecs)))``
(``launch/dryrun.py:70-89``); :class:`ShardedServeStep` is the twin of
its prefill and decode ``jit``s, which the dry run (``launch.dryrun``)
runs.

At rest the parameters and AdamW's ``m`` and ``v`` are DTensors placed by
``steps.param_pspecs`` and ``steps.opt_pspecs``, the batch by
``steps.batch_pspecs`` (:func:`shard` builds them from whole tensors with
no message: each rank keeps its slice, the slice JAX's ``NamedSharding``
puts on the device of the same mesh coordinate). A step

1. gathers each parameter it needs whole (FSDP-style all-gathers over the
   mesh axes that shard it); under expert parallelism
   (``moe.ep_mode``) the MoE ``router/w`` and expert leaves stay this
   rank's shards, which the EP lowerings take as they are;
2. runs ``make_train_step``'s loss on this rank's block of the batch
   under ``axis_rules(rules, mesh)``, and differentiates this rank's share
   of the global loss: its nll weighted by its share of the batch's
   labels, plus the aux term of ``loss_fn`` (the EP collectives' transposes
   give each rank its share of that);
3. reduce-scatters each gathered leaf's gradient over the dp axes to this
   rank's shard of it: the sum over dp ranks in their order, accumulated
   in float32 (the copies across ``model`` are equal);
4. takes the global gradient norm from every leaf's shards, each
   replicated copy counted once, summed in rank order;
5. runs AdamW on the shards, in place.

Its loss and updated parameters equal one process's ``make_train_step``
on the whole batch to rounding: the gradient's sums over tokens run per
rank and then over ranks, and the GEMMs see other row counts
(:func:`step_gaps` holds the two within derived limits). A MoE config
whose EP conditions fail under the mesh runs the dense dispatch on every
rank's block, which is JAX's dense dispatch only with one dp rank: the
step refuses it otherwise.
"""
from __future__ import annotations

import re

import torch
from torch.distributed.tensor import DTensor, Replicate

from .. import tree as T
from ..collectives import axis_ops as ops
from ..models import api, moe
from ..models.config import ModelConfig
from ..optim import adamw
from ..parallel.sharding import axis_rules, map_specs, placements
from . import steps
from .mesh import dp_axes

#: the MoE leaves the EP lowerings take as this rank's shards
EP_LEAVES = re.compile(r".*(router/w|experts/w_(gate|up|down))$")


def local_slice(t: torch.Tensor, mesh, pls, coord) -> torch.Tensor:
    """The block of ``t`` that placements ``pls`` put at mesh coordinate
    ``coord``: DTensor splits a dimension mesh dimension by mesh dimension,
    the first the major one (its sizes must divide)."""
    for size, pl, c in zip(mesh.mesh.shape, pls, coord):
        if pl.is_shard():
            if t.shape[pl.dim] % size:
                raise ValueError(f"dimension {pl.dim} of {tuple(t.shape)} "
                                 f"does not split over {size} ranks")
            t = t.chunk(size, pl.dim)[c]
    return t


def shard(tree, mesh, spec_tree):
    """Whole tensors (equal on every rank) -> DTensors placed by
    ``spec_tree``, each rank keeping its own slice (no message)."""
    coord = mesh.get_coordinate()

    def one(spec, t):
        pls = placements(mesh, spec, t.ndim)
        local = local_slice(t, mesh, pls, coord).detach().clone()
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return map_specs(one, spec_tree, tree)


def gather(d) -> torch.Tensor:
    """A DTensor's whole value on every rank (all-gathers over the mesh
    dimensions that shard it, the minor one first; no gradient)."""
    mesh = d.device_mesh
    with torch.no_grad():
        local = d.to_local()
        for i in reversed(range(mesh.ndim)):
            pl = d.placements[i]
            if pl.is_shard():
                ax = ops.axis(mesh, mesh.mesh_dim_names[i])
                local = ops.all_gather(local, ax, pl.dim)
    return local


def gather_tree(tree):
    return T.tree_map(gather, tree)


def gather_to(d, dst: int = 0):
    """A DTensor's whole value on global rank ``dst`` (in host memory where
    gloo stages the messages), None on the other ranks: each rank's shard
    sent to ``dst`` alone, placed there by its mesh coordinate."""
    from ..collectives.tree_allreduce import Link
    mesh = d.device_mesh
    with torch.no_grad():
        local = d.to_local().contiguous()
        parts = Link(None, local.device).gather(local, dst)
    if parts is None:
        return None
    full = parts.new_empty(d.shape)
    for r, part in enumerate(parts):
        coord = [int(c[0]) for c in torch.nonzero(mesh.mesh == r,
                                                  as_tuple=True)]
        local_slice(full, mesh, d.placements, coord).copy_(part)
    return full


def _reduce_to_shard(g, mesh, pls, coord, dp_dims, dpa):
    """This rank's shard of the sum over the dp ranks of their ``g``: each
    rank sends every dp peer that peer's shard of its ``g`` (one
    all-to-all), then sums what it receives in dp-rank order."""
    if dpa.size == 1:
        return local_slice(g, mesh, pls, coord).contiguous()
    parts = []
    for j in range(dpa.size):
        c, rest = list(coord), j
        for i in reversed(dp_dims):
            c[i], rest = rest % mesh.mesh.shape[i], rest // mesh.mesh.shape[i]
        parts.append(local_slice(g, mesh, pls, c))
    with torch.no_grad():
        got = ops.all_to_all(torch.stack(parts), dpa)
    return ops.ordered_sum(list(got), g.dtype)


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, out)`` on
    DTensor trees placed by ``named(mesh, param_pspecs)``, ``named(mesh,
    opt_pspecs)`` and ``named(mesh, batch_pspecs)``; parameters and moments
    are updated in place; ``out`` = ``{"loss", "grad_norm", "nll", "aux"}``,
    equal on every rank. Every rank of ``mesh`` calls it with its own
    shards."""

    def __init__(self, cfg: ModelConfig, ocfg: adamw.AdamWConfig, mesh,
                 rules):
        self.cfg, self.ocfg, self.mesh, self.rules = cfg, ocfg, mesh, rules
        self.lfn = api.loss_fn(cfg)
        names = tuple(mesh.mesh_dim_names)
        self.dp = dp_axes(mesh)
        self.dp_dims = [names.index(a) for a in self.dp]
        self.dpa = ops.axis(mesh, self.dp)
        self.every = ops.axis(mesh, names)

    def ep(self, batch_local) -> str | None:
        """The MoE lowering this step's tokens take (None: dense)."""
        if not self.cfg.is_moe:
            return None
        n = batch_local["tokens"].numel()
        mode = moe.ep_mode(n, self.cfg, self.mesh, self.rules)
        if mode is None and self.dpa.size > 1:
            raise ValueError(
                f"{self.cfg.name}: the MoE layers would take the dense "
                f"dispatch on each of {self.dpa.size} dp blocks, which is "
                f"not JAX's dispatch over the whole batch")
        return mode

    def __call__(self, params, opt_state, batch):
        mesh, coord = self.mesh, self.mesh.get_coordinate()
        with torch.no_grad():
            blocal = {k: v.to_local() for k, v in batch.items()}
        ep = self.ep(blocal)
        named = list(T.leaves_with_paths(params))
        keep = [ep is not None and EP_LEAVES.fullmatch(p) is not None
                for p, _ in named]
        with torch.no_grad():
            used = [(d.to_local() if k else gather(d)).detach()
                    for (_, d), k in zip(named, keep)]
        for t in used:
            t.requires_grad_()
        local_params = T.unflatten({p: t for (p, _), t in zip(named, used)},
                                   like=params)
        with axis_rules(self.rules, mesh):
            loss, metrics = self.lfn(local_params, blocal)
            nll = metrics["nll"]
            count = (blocal["labels"] >= 0).sum().to(torch.float32)
            counts = ops.psum(count.reshape(1), self.dpa)[0]
            share = count / torch.clamp(counts, min=1.0)
            grads = list(torch.autograd.grad(nll * share + (loss - nll),
                                             used))
        del local_params, used          # the gathered parameters
        with torch.no_grad():
            out_g, sq = [], torch.zeros((), dtype=torch.float32,
                                        device=loss.device)
            for i, ((path, d), k) in enumerate(zip(named, keep)):
                g, grads[i] = grads[i], None     # free each whole gradient
                pls = d.placements
                gs = g if k else _reduce_to_shard(
                    g, mesh, pls, coord, self.dp_dims, self.dpa)
                del g
                out_g.append(gs)
                if all(c == 0 for c, pl in zip(coord, pls)
                       if pl.is_replicate()):
                    sq = sq + torch.sum(torch.square(gs.to(torch.float32)))
            gnorm = torch.sqrt(ops.psum(sq.reshape(1), self.every)[0])
            nll_all = ops.psum((nll.detach() * share).reshape(1),
                               self.dpa)[0]
            out = {"loss": nll_all + (loss - nll).detach(),
                   "grad_norm": gnorm, "nll": nll_all,
                   "aux": metrics["aux"].detach()}
            p_local = T.unflatten({p: d.to_local() for p, d in named},
                                  like=params)
            g_local = T.unflatten({p: g for (p, _), g in zip(named, out_g)},
                                  like=params)
            step = opt_state["step"].to_local()
            o_local = {"m": T.tree_map(lambda d: d.to_local(),
                                       opt_state["m"]),
                       "v": T.tree_map(lambda d: d.to_local(),
                                       opt_state["v"]),
                       "step": step}
            lr_scale = adamw.cosine_lr(step, 2000, 100_000)
            _, o_local, _ = adamw.update(g_local, o_local, p_local,
                                         self.ocfg, lr_scale, grad_norm=gnorm)
            opt_state["step"] = DTensor.from_local(
                o_local["step"], mesh, opt_state["step"].placements,
                run_check=False)
        return params, opt_state, out


#: cache leaves whose dimension after the batch is the sequence: a rank
#: serves its block of positions of these
SEQ_CACHES = ("k", "v", "ckv", "kr")


class ShardedServeStep:
    """The serving steps over a device mesh, the port's twin of the JAX
    package's ``jit(make_prefill_step, in_shardings=(named(mesh,
    param_pspecs), named(mesh, batch_pspecs)))`` and ``jit(make_serve_step,
    in_shardings=(params, named(mesh, cache_pspecs), P(), P()))``
    (``launch/dryrun.py:94-122``). ``mode`` is ``"prefill"`` or
    ``"decode"``.

    Every rank gathers the parameters whole (``gather_tree``; under expert
    parallelism the MoE ``router/w`` and expert leaves stay this rank's
    shards, as in :class:`ShardedTrainStep`) and, under ``axis_rules(rules,
    mesh)``, runs ``make_prefill_step`` on its block of the batch, or
    ``make_serve_step`` on its block of the caches with its rows of the
    token: ``step(params, caches, token, pos)``, ``token`` this rank's
    rows (B / dp, 1), ``pos`` a host int within its block. A cache keeps
    this rank's block of its batch rows and, for the k/v-like leaves
    (``SEQ_CACHES``), of its positions; a recurrent state sharded on a
    feature dimension is gathered whole first, since the gathered
    parameters expect it whole. Each rank attends over its own block of
    positions and its result is its block's: the step reckons a rank's
    work and memory (``launch.dryrun``); unlike JAX's it does not combine
    the positions of the ``model`` ranks into one softmax."""

    def __init__(self, cfg: ModelConfig, mesh, rules, mode: str):
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode {mode!r} is prefill or decode")
        self.cfg, self.mesh, self.rules, self.mode = cfg, mesh, rules, mode
        self.fn = (steps.make_prefill_step(cfg) if mode == "prefill"
                   else steps.make_serve_step(cfg))

    def _params(self, params, n_tokens: int):
        ep = (moe.ep_mode(n_tokens, self.cfg, self.mesh, self.rules)
              if self.cfg.is_moe else None)
        named = T.leaves_with_paths(params)
        return T.unflatten(
            {p: (d.to_local() if ep is not None and EP_LEAVES.fullmatch(p)
                 else gather(d)) for p, d in named}, like=params)

    def __call__(self, params, data, token=None, pos: int | None = None):
        with torch.no_grad():
            if self.mode == "prefill":
                local = {k: v.to_local() for k, v in data.items()}
                n = local["tokens"].numel()
            else:
                local = T.unflatten(
                    {p: self._cache_block(p, d)
                     for p, d in T.leaves_with_paths(data)}, like=data)
                n = token.numel()
            used = self._params(params, n)
        with axis_rules(self.rules, self.mesh):
            if self.mode == "prefill":
                return self.fn(used, local)
            return self.fn(used, local, token, pos)

    def _cache_block(self, path: str, d) -> torch.Tensor:
        """This rank's block of cache leaf ``d``: its batch rows and, for a
        ``SEQ_CACHES`` leaf, its positions; any other sharded dimension
        gathered."""
        names = path.split("/")
        stacked = any(n in ("layers", "dec") for n in names)
        b_dim = 1 if stacked and d.ndim >= 2 else 0
        keep = {b_dim} | ({b_dim + 1} if names[-1] in SEQ_CACHES else set())
        local = d.to_local()
        mesh = d.device_mesh
        for i in reversed(range(mesh.ndim)):
            pl = d.placements[i]
            if pl.is_shard() and pl.dim not in keep:
                ax = ops.axis(mesh, mesh.mesh_dim_names[i])
                local = ops.all_gather(local, ax, pl.dim)
        return local


def init_opt(params, ocfg: adamw.AdamWConfig, step: int = 0) -> dict:
    """AdamW's state for sharded ``params``: zero moments placed as the
    parameters (``opt_pspecs``), the step count replicated."""

    def zeros(d):
        local = torch.zeros(d.to_local().shape,
                            dtype=getattr(torch, ocfg.moment_dtype),
                            device=d.to_local().device)
        return DTensor.from_local(local, d.device_mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    first = T.leaves(params)[0]
    mesh = first.device_mesh
    count = torch.tensor(step, dtype=torch.int32,
                         device=first.to_local().device)
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": DTensor.from_local(count, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)}


def shard_state(params, opt_state, batch, mesh, rules, shape):
    """Whole state and batch (equal on every rank) -> their DTensors by
    ``param_pspecs``, ``opt_pspecs`` and ``batch_pspecs``."""
    pspec = steps.param_pspecs(params, rules)
    return (shard(params, mesh, pspec),
            shard(opt_state, mesh, steps.opt_pspecs(pspec)),
            shard(batch, mesh, steps.batch_pspecs(batch, mesh, shape)))


# ---------------------------------------------------------------------------
# Agreement with one process's step
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24                  # float32 unit roundoff
CHUNK = 1 << 24                   # elements step_gaps reads at a time
UNIT = {torch.float32: U32, torch.bfloat16: 2.0 ** -8}


def step_limit(cfg: ModelConfig, n_tokens: int) -> float:
    """The relative limit of a gradient-linear quantity (loss, gradient
    norm, first moment) between the sharded step and one process's.

    The two compute each gradient entry as float32-accumulated sums over
    the same terms in other orders: per rank then over ranks, and GEMMs
    that see N / dp rows instead of N choose other blockings. A float32
    sum of n terms is within (n - 1) u32 of the exact one relative to the
    terms' magnitudes, so the two are within 2 n u32 of each other, n the
    longest sum of the step: the tokens (the weight gradients), d_model,
    the MLP width or the vocabulary (the activation gradients). Where the
    parameters are bfloat16 the GEMMs round their outputs to it: an
    output's rounding may differ (2 u), as may the rounding of the two
    partial sums and of their sum (3 u) and of the activations feeding
    them (2 u): 8 u of the parameter dtype with one u to spare. The
    magnitudes are taken as the leaf's largest value."""
    n = max(n_tokens, cfg.d_model, cfg.d_ff, cfg.d_ff_expert or 0,
            cfg.padded_vocab)
    dt = UNIT[getattr(torch, cfg.dtype)]
    return 2 * n * U32 + (8 * dt if dt != U32 else 0.0)


def _ratio(g: torch.Tensor, ocfg, step: int) -> torch.Tensor:
    """AdamW's update direction for gradient x clip ``g`` from zero
    moments at step ``step`` (float64)."""
    bc1 = 1.0 - ocfg.b1 ** step
    bc2 = 1.0 - ocfg.b2 ** step
    mhat = (1 - ocfg.b1) * g / bc1
    vhat = (1 - ocfg.b2) * g * g / bc2
    return mhat / (torch.sqrt(vhat) + ocfg.eps)


def step_gaps(ref: dict, got: dict, cfg: ModelConfig, ocfg, n_tokens: int,
              lr: float, step: int) -> dict:
    """Each reading of the sharded step against one process's step over
    its limit (a value <= 1 agrees): ``ref`` holds ``loss``,
    ``grad_norm`` and path -> tensor dicts ``params`` (after the step),
    ``m``, ``v`` and ``before`` (the parameters before); ``got`` the loss,
    the norm and any of ``params``, ``m`` and ``v`` (those it lacks are
    not read). The moments started at zero, the update was AdamW's
    ``step``-th at learning rate ``lr`` (``ocfg.lr`` times the schedule's
    scale). The leaves may lie on other devices; they are read ``CHUNK``
    elements at a time on ``ref``'s, in float32.

    Loss, gradient norm and each leaf's ``m`` (the clipped gradient times
    1 - b1) are held to :func:`step_limit` of their largest value, ``v``
    (quadratic in it) to twice that. A parameter moves by lr times the
    update direction r(g) = mhat / (sqrt(vhat) + eps) plus weight decay:
    each element is held to lr times the most r can move for a gradient
    within the limit of the reference's, plus 4 u of the parameter's dtype
    times |p before| + lr |r| + |p after| (the update's roundings: the
    product, the direction's few operations and the difference, on both
    sides). Where a gradient near zero changes sign within its limit, the
    first term alone reaches the reading, so readings up to 1 are
    expected there."""
    lim = step_limit(cfg, n_tokens)
    out = {"loss": abs(got["loss"] - ref["loss"]) / (lim * abs(ref["loss"])),
           "grad_norm": abs(got["grad_norm"] - ref["grad_norm"])
           / (lim * ref["grad_norm"])}
    keys = [k for k in ("m", "v", "params") if k in got]
    worst = dict.fromkeys(keys, 0.0)
    f32 = torch.float32

    def pieces(t, dev):
        flat = t.reshape(-1)
        return [flat[i:i + CHUNK].to(dev, f32)
                for i in range(0, flat.numel(), CHUNK)]

    for path, m_ref in ref["m"].items():
        dev = m_ref.device
        scale = {k: max(float(c.abs().max()) for c in pieces(ref[k][path],
                                                             dev))
                 for k in ("m", "v")}
        delta = lim * scale["m"] / (1 - ocfg.b1)    # on clip x gradient
        unit = UNIT[ref["params"][path].dtype]
        refs = {k: pieces(ref[k][path], dev)
                for k in ("m", "v", "params", "before")}
        gots = {k: pieces(got[k][path], dev) for k in keys}
        for i, mr in enumerate(refs["m"]):
            for key, rel in (("m", lim), ("v", 2 * lim)):
                if key not in gots:
                    continue
                gap = float((gots[key][i] - refs[key][i]).abs().max())
                if scale[key] > 0:
                    worst[key] = max(worst[key], gap / (rel * scale[key]))
                elif gap > 0:
                    worst[key] = float("inf")
            if "params" not in gots:
                continue
            pr, pb = refs["params"][i], refs["before"][i]
            cg = mr / (1 - ocfg.b1)
            r0 = _ratio(cg, ocfg, step)
            move = torch.maximum((_ratio(cg + delta, ocfg, step) - r0).abs(),
                                 (_ratio(cg - delta, ocfg, step) - r0).abs())
            size = pb.abs() + lr * r0.abs() + pr.abs()
            bound = lr * move + 4 * unit * size + 1e-30
            worst["params"] = max(worst["params"], float(
                ((gots["params"][i] - pr).abs() / bound).max()))
    out.update(worst)
    return out
