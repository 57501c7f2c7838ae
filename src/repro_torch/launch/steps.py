"""Train, prefill and serve steps and the sharding-spec derivation: the
port of the JAX package's ``launch/steps.py``.

``make_train_step`` is JAX's step on one process: the loss and its
gradient, ``adamw.cosine_lr(step, 2000, 100_000)`` and the AdamW update
(parameters and moments written in place). The trainer with the SOAR
reduce is ``launch.train``'s ``make_step``; the step over a device mesh is
``launch.sharded``'s. The serving steps run under ``torch.inference_mode()``
(no autograd graph: at full size the weights leave no room for one) and
return the greedy next token (B, 1) int32 and the caches; the serve step
writes the token's k/v into the caches in place.

The spec functions (``rules_for``, ``batch_pspecs``, ``cache_pspecs``,
``param_pspecs``, ``opt_pspecs``) read only a mesh's axis names and sizes
(``mesh_dim_names`` and ``mesh.shape``), so a stand-in with those two
attributes derives the specs of a production mesh without its ranks; they
give JAX's ``PartitionSpec`` entry for entry. ``named`` maps a spec tree
to DTensor placements on a ``DeviceMesh``. ``abstract_state``,
``abstract_batch`` and ``abstract_caches`` build the trees on the meta
device: shapes and dtypes, no storage.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import tree as T
from ..models import api
from ..models.config import ModelConfig
from ..optim import adamw
from ..parallel.sharding import (AxisRules, PartitionSpec, make_rules,
                                 map_specs, map_with_path,
                                 param_sharding_specs, placements)
from .mesh import dp_axes, dp_size, mesh_axis_sizes

P = PartitionSpec


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The first largest logit of the last position, (B, 1) int32."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state, out)``,
    ``out`` = ``{"loss", "grad_norm", **metrics}``; params and moments are
    updated in place."""
    lfn = api.loss_fn(cfg)

    def train_step(params, opt_state, batch):
        leaves = T.leaves(params)
        loss, metrics = lfn(params, batch)
        grads = T.unflatten(
            dict(zip((p for p, _ in T.leaves_with_paths(params)),
                     torch.autograd.grad(loss, leaves))), like=params)
        lr_scale = adamw.cosine_lr(opt_state["step"], 2000, 100_000)
        params, opt_state, gnorm = adamw.update(grads, opt_state, params,
                                                ocfg, lr_scale)
        out = {"loss": loss.detach(), "grad_norm": gnorm}
        out.update({k: v.detach() for k, v in metrics.items()})
        return params, opt_state, out

    return train_step


def make_prefill_step(cfg: ModelConfig):
    pfn = api.prefill_fn(cfg)

    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, caches = pfn(params, batch)
            return _greedy(logits), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    dfn = api.decode_fn(cfg)

    def serve_step(params, caches, token, pos: int):
        with torch.inference_mode():
            logits, caches = dfn(params, caches, token, pos)
            return _greedy(logits), caches

    return serve_step


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

def rules_for(mesh, shape: api.ShapeSpec | None = None,
              seq_shard: bool = False) -> AxisRules:
    multi = "pod" in mesh.mesh_dim_names
    rules = make_rules(multi, seq_shard=seq_shard)
    rules["kv_heads"] = None  # Hkv < TP width for most archs: replicate KV
    if shape is not None and shape.global_batch < dp_size(mesh):
        rules["batch"] = None           # e.g. long_500k: batch 1
        rules["tokens_flat"] = ("model",)
    return rules


def batch_pspecs(batch: Any, mesh, shape: api.ShapeSpec) -> Any:
    dp = dp_axes(mesh)
    bsh = None if shape.global_batch % dp_size(mesh) else dp

    def spec(_, leaf):
        s = [None] * leaf.ndim
        if leaf.ndim >= 1 and bsh:
            s[0] = bsh
        return P(*s)

    return map_with_path(spec, batch)


def cache_pspecs(caches: Any, mesh, shape: api.ShapeSpec) -> Any:
    """Shard caches: batch dim over DP when divisible; the largest remaining
    dim (typically the seq_len axis, flash-decoding style) over 'model'."""
    dp = dp_axes(mesh)
    dpn = dp_size(mesh)
    msize = mesh_axis_sizes(mesh)["model"]

    def spec(path, leaf):
        names = path.split("/")
        stacked = any(n in ("layers", "dec") for n in names)
        s: list = [None] * leaf.ndim
        b_dim = 1 if (stacked and leaf.ndim >= 2) else 0
        if leaf.ndim > b_dim and leaf.shape[b_dim] % dpn == 0:
            s[b_dim] = dp
        rest = [(leaf.shape[i], i) for i in range(leaf.ndim)
                if i != b_dim and (not stacked or i > 0)]
        for size, i in sorted(rest, reverse=True):
            if size % msize == 0 and size >= msize:
                s[i] = "model"
                break
        return P(*s)

    return map_with_path(spec, caches)


def param_pspecs(params: Any, rules: AxisRules) -> Any:
    return param_sharding_specs(
        params, rules, stacked_prefixes=("layers", "enc_layers", "dec_layers"))


def opt_pspecs(pspecs: Any) -> Any:
    return {"m": pspecs, "v": pspecs, "step": P()}


def named(mesh, spec_tree):
    """The spec tree as DTensor placements on ``mesh`` (a tuple of
    ``Shard``/``Replicate`` per leaf, one per mesh dimension)."""
    return map_specs(lambda s: placements(mesh, s, len(s)), spec_tree)


# ---------------------------------------------------------------------------
# Abstract (allocation-free) inputs
# ---------------------------------------------------------------------------

def abstract_state(cfg: ModelConfig, ocfg: adamw.AdamWConfig | None = None):
    params = api.init_fn(cfg, device="meta")(0)
    if ocfg is None:
        return params
    return params, adamw.init(params, ocfg)


def abstract_batch(cfg: ModelConfig, shape: api.ShapeSpec, mode=None):
    return api.input_specs(cfg, shape, mode, device="meta")


def abstract_caches(cfg: ModelConfig, shape: api.ShapeSpec):
    return api.init_caches(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
