"""The training and serving steps over a device mesh, one rank a device:
the port's twins of the JAX package's ``jit(make_train_step,
in_shardings=(named(mesh, param_pspecs), named(mesh, opt_pspecs),
named(mesh, batch_pspecs)))`` (``launch/dryrun.py:70-89``) and of its
prefill and decode ``jit``s (:class:`ShardedServeStep`), which the dry run
(``launch.dryrun``) runs.

At rest the parameters and AdamW's ``m`` and ``v`` are DTensors placed by
``steps.param_pspecs`` and ``steps.opt_pspecs``, the batch by
``steps.batch_pspecs``, the caches by ``steps.cache_pspecs`` (:func:`shard`
builds them from whole tensors with no message: each rank keeps its
slice, the slice JAX's ``NamedSharding`` puts on the device of the same
mesh coordinate). A training step

1. hands the model this rank's shards under a ``layer_gather.Plan``: each
   layer gathers its own shards inside its body (under
   ``torch.utils.checkpoint`` where ``cfg.remat``, so the recompute gathers
   again), the GQA attention's and the MLP's products split over
   ``model`` (column-parallel ``w_q``/``w_k``/``w_v``/``w_gate``/``w_up``,
   row-parallel ``w_o``/``w_down`` and one sum over ``model``), the
   embedding and the head split the vocabulary over ``model``; MLA, the
   SSM mixers and MoE's dense dispatch gather their ``model`` shards too
   and compute alike on every ``model`` rank; under expert parallelism
   (``moe.ep_mode``) the MoE ``router/w`` and expert leaves stay this
   rank's shards, which the EP lowerings take as they are;
2. runs ``make_train_step``'s loss on this rank's block of the batch
   under ``axis_rules(rules, mesh)``, and differentiates this rank's share
   of the global loss: its nll weighted by its share of the batch's
   labels, plus the aux term of ``loss_fn`` (the EP collectives' transposes
   give each rank its share of that); each layer's gather takes its
   gradient back to this rank's shard as the backward reaches it
   (reduce-scattered over the dp axes, summed in dp-rank order in
   float32; over ``model`` this rank's slice where the ranks computed
   alike, the sum where they computed parts), so no whole gradient is
   held;
3. takes the global gradient norm from every leaf's shards, each
   replicated copy counted once, summed in rank order;
4. runs AdamW on the shards, in place.

Its loss and updated parameters equal one process's ``make_train_step``
on the whole batch to rounding: the gradient's sums over tokens run per
rank and then over ranks, and the GEMMs see other row and column counts
(:func:`step_gaps` holds the two within derived limits). A MoE config
whose EP conditions fail under the mesh runs the dense dispatch on every
rank's block, which is JAX's dense dispatch only with one dp rank: the
step refuses it otherwise.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from .. import tree as T
from ..collectives import axis_ops as ops
from ..models import api, moe
from ..models.config import ModelConfig
from ..models.transformer import _layer_windows
from ..optim import adamw
from ..parallel import layer_gather as lg
from ..parallel.layer_gather import local_slice
from ..parallel.sharding import axis_rules, map_specs, placements
from . import steps
from .mesh import dp_axes


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


def _plan(cfg, mesh, params, train: bool, ep) -> lg.Plan:
    return lg.Plan(cfg, mesh, {p: d.placements for p, d in
                               T.leaves_with_paths(params)}, train=train,
                   ep=ep)


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, out)`` on
    DTensor trees placed by ``named(mesh, param_pspecs)``, ``named(mesh,
    opt_pspecs)`` and ``named(mesh, batch_pspecs)``; parameters and moments
    are updated in place; ``out`` = ``{"loss", "grad_norm", "nll", "aux"}``,
    equal on every rank. Every rank of ``mesh`` calls it with its own
    shards. ``plan`` is the last step's ``layer_gather.Plan``."""

    def __init__(self, cfg: ModelConfig, ocfg: adamw.AdamWConfig, mesh,
                 rules):
        self.cfg, self.ocfg, self.mesh, self.rules = cfg, ocfg, mesh, rules
        self.lfn = api.loss_fn(cfg)
        names = tuple(mesh.mesh_dim_names)
        self.dp = dp_axes(mesh)
        self.dpa = ops.axis(mesh, self.dp)
        self.every = ops.axis(mesh, names)
        self.plan = None

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
        plan = self.plan = _plan(self.cfg, mesh, params, True,
                                 self.ep(blocal))
        named = list(T.leaves_with_paths(params))
        used = [d.to_local().detach().requires_grad_() for _, d in named]
        local_params = T.unflatten({p: t for (p, _), t in zip(named, used)},
                                   like=params)
        with axis_rules(self.rules, mesh), lg.installed(plan):
            loss, metrics = self.lfn(local_params, blocal)
            nll = metrics["nll"]
            count = (blocal["labels"] >= 0).sum().to(torch.float32)
            counts = ops.psum(count.reshape(1), self.dpa)[0]
            share = count / torch.clamp(counts, min=1.0)
            grads = list(torch.autograd.grad(nll * share + (loss - nll),
                                             used))
        del local_params, used
        missed = [p for p, _ in named
                  if p not in plan.seen and plan.role(p) != "keep"]
        if missed:
            raise RuntimeError(f"leaves the model read past the layer "
                               f"gather (their gradients are not reduced): "
                               f"{missed}")
        with torch.no_grad():
            sq = torch.zeros((), dtype=torch.float32, device=loss.device)
            for (path, d), g in zip(named, grads):
                if all(c == 0 for c, pl in zip(coord, d.placements)
                       if pl.is_replicate()):
                    sq = sq + torch.sum(torch.square(g.to(torch.float32)))
            gnorm = torch.sqrt(ops.psum(sq.reshape(1), self.every)[0])
            nll_all = ops.psum((nll.detach() * share).reshape(1),
                               self.dpa)[0]
            out = {"loss": nll_all + (loss - nll).detach(),
                   "grad_norm": gnorm, "nll": nll_all,
                   "aux": metrics["aux"].detach()}
            p_local = T.unflatten({p: d.to_local() for p, d in named},
                                  like=params)
            g_local = T.unflatten({p: g for (p, _), g in zip(named, grads)},
                                  like=params)
            del grads
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


#: cache leaves whose dimension after the batch is the sequence
SEQ_CACHES = ("k", "v", "ckv", "kr")


class ShardedServeStep:
    """The serving steps over a device mesh, the port's twin of the JAX
    package's ``jit(make_prefill_step, in_shardings=(named(mesh,
    param_pspecs), named(mesh, batch_pspecs)))`` and ``jit(make_serve_step,
    in_shardings=(params, named(mesh, cache_pspecs), P(), P()))``
    (``launch/dryrun.py:94-122``). ``mode`` is ``"prefill"`` or
    ``"decode"``; both return ``(token, caches)``, ``token`` this rank's
    rows (B / dp, 1) int32 of the greedy next token, equal on the ``model``
    ranks.

    Under a ``layer_gather.Plan`` each layer gathers its shards in its
    body (the MLP split over ``model``; the attention whole on every
    ``model`` rank; under expert parallelism the MoE ``router/w`` and
    expert leaves stay this rank's shards), and the head splits the
    vocabulary over ``model``: the next token is the argmax across the
    vocabulary's blocks (the largest value, the lower index on a tie, as
    ``jnp.argmax``).

    ``step(params, batch)`` (prefill) runs on this rank's block of the
    batch and returns the caches as DTensors placed by ``cache_pspecs``,
    each rank keeping its block. ``step(params, caches, token, pos)``
    (decode) takes the caches placed so, this rank's token rows and
    ``pos``, the sequence's own position (a host int), and writes the
    token into the caches in place. The k/v of a full-attention layer stay
    this rank's block of positions: the rank whose block holds ``pos``
    writes there, each rank attends over the filled part of its block,
    and the ``model`` ranks merge by log-sum-exp (``gqa_decode``; the
    encoder-decoder's self and cross attention alike). The other cache
    leaves are gathered whole over their sharded dimensions other than the
    batch (MLA's latent ``ckv``/``kr``, a windowed layer's ring, the
    recurrent states), written, and this rank's block written back. ``keep_logits``: the last
    position's logits, whole, in ``.logits`` after each call."""

    def __init__(self, cfg: ModelConfig, mesh, rules, mode: str,
                 keep_logits: bool = False):
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode {mode!r} is prefill or decode")
        self.cfg, self.mesh, self.rules, self.mode = cfg, mesh, rules, mode
        self.fn = (api.prefill_fn(cfg) if mode == "prefill"
                   else api.decode_fn(cfg))
        self.keep_logits, self.logits = keep_logits, None

    def _ep(self, n_tokens: int):
        return (moe.ep_mode(n_tokens, self.cfg, self.mesh, self.rules)
                if self.cfg.is_moe else None)

    def __call__(self, params, data, token=None, pos: int | None = None):
        with torch.inference_mode():
            used = T.tree_map(lambda d: d.to_local(), params)
            if self.mode == "prefill":
                local = {k: v.to_local() for k, v in data.items()}
                plan = _plan(self.cfg, self.mesh, params, False,
                             self._ep(local["tokens"].numel()))
                with axis_rules(self.rules, self.mesh), lg.installed(plan):
                    logits, caches = self.fn(used, local)
                    tok = self._token(logits, plan)
                return tok, self._place(caches, data["tokens"])
            plan = _plan(self.cfg, self.mesh, params, False,
                         self._ep(token.numel()))
            back, blocks = [], {}
            for p, d in T.leaves_with_paths(data):
                blocks[p] = self._cache_block(p, d, back, plan)
            local = T.unflatten(blocks, like=data)
            with axis_rules(self.rules, self.mesh), lg.installed(plan):
                logits, _ = self.fn(used, local, token, pos)
                tok = self._token(logits, plan)
            coord = self.mesh.get_coordinate()
            for d, whole, pls in back:
                d.to_local().copy_(local_slice(whole, self.mesh, pls, coord))
            return tok, data

    def _token(self, logits, plan) -> torch.Tensor:
        last = logits[:, -1]
        if self.keep_logits:
            self.logits = (ops.all_gather(last.contiguous(), plan.model, -1)
                           if plan.vocab else last.clone())
        return lg.argmax(last).to(torch.int32)[:, None]

    def _place(self, caches, tokens):
        """A prefill's caches (this rank's batch rows, every position) as
        DTensors placed by ``cache_pspecs``: each rank keeps its block."""
        mesh = self.mesh
        dp = [i for i, a in enumerate(mesh.mesh_dim_names)
              if a in dp_axes(mesh)]
        rows = 1
        for i in dp:
            if tokens.placements[i].is_shard():
                rows *= mesh.mesh.shape[i]
        coord = mesh.get_coordinate()

        def whole_shape(path, t):
            names = path.split("/")
            stacked = any(n in ("layers", "dec") for n in names)
            shape = list(t.shape)
            shape[1 if stacked and t.ndim >= 2 else 0] *= rows
            return torch.empty(shape, dtype=t.dtype, device="meta")

        meta = steps.map_with_path(whole_shape, caches)
        specs = steps.cache_pspecs(meta, mesh, None)

        def one(spec, t, m):
            pls = placements(mesh, spec, t.ndim)
            mine = tuple(Replicate() if i in dp else pl
                         for i, pl in enumerate(pls))
            local = local_slice(t, mesh, mine, coord).contiguous()
            return DTensor.from_local(local, mesh, pls, run_check=False,
                                      shape=m.shape, stride=m.stride())

        return map_specs(one, specs, caches, meta)

    def _cache_block(self, path: str, d, back: list, plan) -> torch.Tensor:
        """This rank's block of cache leaf ``d``: its batch rows and, for
        a full-attention layer's k/v, its block of positions (noted in the
        plan's ``blocks`` where ``model`` splits them); any other sharded
        dimension gathered (``back`` notes the leaf, to write its block
        back)."""
        names = path.split("/")
        stacked = any(n in ("layers", "dec") for n in names)
        b_dim = 1 if stacked and d.ndim >= 2 else 0
        block = (names[-1] in ("k", "v")
                 and not self._ring(names, d.shape[b_dim + 1]))
        keep = {b_dim} | ({b_dim + 1} if block else set())
        local = d.to_local()
        mesh = d.device_mesh
        if block and "model" in mesh.mesh_dim_names:
            pl = d.placements[mesh.mesh_dim_names.index("model")]
            if pl.is_shard() and pl.dim == b_dim + 1:
                plan.blocks[local.shape[b_dim + 1]] = d.shape[b_dim + 1]
        gathered = [Replicate()] * mesh.ndim
        for i in reversed(range(mesh.ndim)):
            pl = d.placements[i]
            if pl.is_shard() and pl.dim not in keep:
                ax = ops.axis(mesh, mesh.mesh_dim_names[i])
                local = ops.all_gather(local, ax, pl.dim)
                gathered[i] = pl
        if any(pl.is_shard() for pl in gathered):
            back.append((d, local, tuple(gathered)))
        return local

    def _ring(self, names, s: int) -> bool:
        """Whether the k/v at ``names`` (a leaf of the ``blocks`` list) is
        a windowed layer's ring of ``s`` slots."""
        if names[0] != "blocks":
            return False
        w = _layer_windows(self.cfg)[int(names[1])]
        return bool(w) and w < s + 1


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
