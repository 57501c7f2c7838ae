"""Model API and the assigned input shapes: the port of the JAX package's
``models/api.py``, plus the weight and cache converters.

  init_fn(cfg, device)(seed_or_generator) -> params (nested dicts of
      leaf tensors that require grad, keyed as the JAX pytree)
  loss_fn(cfg)(params, batch) -> (loss, metrics)
  prefill_fn(cfg)(params, batch) -> (last_logits, caches)
  decode_fn(cfg)(params, caches, token, pos) -> (logits, caches), the
      caches written in place
  init_caches(cfg, batch, seq, device) -> zero caches (an MoE model's
      dense prefix blocks one each in ``prefix``, then the stack; or one
      per block for the hybrid and xLSTM families; the encoder-decoder's
      ``{"dec": {"self", "cross"}}``, ``seq`` the encoder's length)
  decode_caches(cfg, prefill_caches, batch, n_steps) -> decode caches for
      ``n_steps`` steps with the prefill's handed over; the first step's
      position is ``decode_start(batch)``
  input_specs(cfg, shape, mode, device) -> batch of zeros (frames for the
      encoder-decoder, ``prefix_embeds`` for a VLM)
  params_from_jax(tree_of_numpy) / params_to_numpy(params): 1:1 by key,
      lists kept lists (an MoE model's ``prefix`` blocks, the ``blocks``
      list) and an MoE layer's ``moe/{router, experts, shared}`` leaves as
      they are, whisper's stacked ``enc_layers``/``dec_layers`` too;
      caches_from_jax / caches_to_numpy likewise for caches

Every config of the zoo dispatches: the encoder-decoder family
(``cfg.is_encoder_decoder``) to ``models/encdec.py``, every other family
to ``models/transformer.py``, as the JAX API does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tree as T
from . import encdec, transformer
from .config import ModelConfig
from .layers import dtype_of


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k dense KV excluded "
                       "(DESIGN.md)")
    return True, ""


def _module(cfg: ModelConfig):
    """The model module of ``cfg``'s family: ``encdec`` (whisper) or
    ``transformer`` (every other family)."""
    return encdec if cfg.is_encoder_decoder else transformer


class _MetaDraws:
    """Stands in for a Generator on the meta device, which torch has not:
    the initializers then make leaves with shapes and dtypes only."""
    device = torch.device("meta")


def init_fn(cfg: ModelConfig, device="cuda"):
    """``init(seed)`` -> params on ``device`` (a seed or a Generator on it;
    on the meta device the seed is not read and nothing is drawn)."""
    mod = _module(cfg)

    def init(seed):
        if torch.device(device).type == "meta":
            gen = _MetaDraws()
        elif isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            params = mod.init_params(cfg, gen)
        return T.tree_map(lambda p: p.requires_grad_(), params)

    return init


def _bound(cfg: ModelConfig, name: str):
    """``name`` of ``cfg``'s family with ``cfg`` bound; the
    encoder-decoder's also with the position tables that the returned
    function owns (``encdec._positions``)."""
    mod = _module(cfg)
    if not cfg.is_encoder_decoder:
        return lambda *args: getattr(mod, name)(*args, cfg)
    tables = {}
    return lambda *args: getattr(mod, name)(*args, cfg, tables)


def loss_fn(cfg: ModelConfig):
    return _bound(cfg, "loss_fn")


def prefill_fn(cfg: ModelConfig):
    return _bound(cfg, "prefill")


def decode_fn(cfg: ModelConfig):
    return _bound(cfg, "decode_step")


def init_caches(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Zero caches for a ``seq``-token context; for the encoder-decoder
    ``seq`` is the encoder's length (the cross caches), the self caches
    ``encdec.WHISPER_MAX_TARGET`` slots."""
    return _module(cfg).init_caches(cfg, batch, seq, device)


def decode_start(batch: dict) -> int:
    """The position of the first decode step after a prefill of ``batch``:
    its tokens, and a VLM's prefix embeddings ahead of them."""
    pre = batch.get("prefix_embeds")
    return batch["tokens"].shape[1] + (0 if pre is None else pre.shape[1])


def decode_caches(cfg: ModelConfig, pre, batch: dict, n_steps: int):
    """Decode caches for ``n_steps`` steps after a prefill of ``batch``
    whose caches are ``pre``: ``init_caches`` for the prompt and the steps
    on the tokens' device (the encoder-decoder's: its 448 self slots, no
    cross slots), and the prefill handed over. The t = ``decode_start``
    positions go in as they are: the stacked layers' k/v (and an MoE
    model's prefix blocks') into [0, t); per block, position p of a k/v of
    S slots into slot p % S for the last min(t, S) positions (a global
    layer: [0, t); a windowed layer's ring: the last S), the Mamba and
    xLSTM states as they are; the encoder-decoder's self k/v into [0, t)
    and its cross caches themselves, no copy."""
    t, tokens = decode_start(batch), batch["tokens"]
    caches = init_caches(cfg, tokens.shape[0],
                         0 if cfg.is_encoder_decoder else t + n_steps,
                         tokens.device)
    with torch.inference_mode():
        if cfg.is_encoder_decoder:
            for n, c in caches["dec"]["self"].items():
                c[:, :, :t].copy_(pre["dec"]["self"][n])
            caches["dec"]["cross"] = pre["dec"]["cross"]
        elif "layers" in caches:                 # k, v; MLA: ckv, kr
            for pb, cb in zip(pre["prefix"], caches["prefix"]):
                for n, c in cb.items():          # MoE's dense prefix blocks
                    c[:, :t].copy_(pb[n])
            for n, c in caches["layers"].items():
                c[:, :, :t].copy_(pre["layers"][n])
        else:
            for pb, cb in zip(pre["blocks"], caches["blocks"]):
                if "attn" not in cb:             # an xLSTM block's state
                    for n, state in cb.items():
                        state.copy_(pb[n])
                    continue
                for n in ("k", "v"):
                    dst = cb["attn"][n]
                    s, lo = dst.shape[1], max(0, t - dst.shape[1])
                    pos = torch.arange(lo, t, device=dst.device) % s
                    dst.index_copy_(1, pos, pb["attn"][n][:, lo:t])
                cb["ssm"]["s"].copy_(pb["ssm"]["s"])
    return caches


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mode: str | None = None,
                device="cuda"):
    """Batch of zeros for (cfg, shape), as the JAX function makes it:
    tokens (B, S) and, to train, labels, int64 as the port's data pipeline
    makes them (JAX: int32). The encoder-decoder takes frames (B, S, d) in
    the model dtype and T = min(max(8, S // target_ratio), 448) tokens to
    train, 8 otherwise; a VLM, to train and prefill, ``prefix_embeds`` (B,
    P, d), P = min(n_prefix_embeds, S // 2), and S - P tokens."""
    mode = mode or shape.kind
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg)

    def ints(t):
        return torch.zeros((B, t), dtype=torch.int64, device=device)

    if cfg.is_encoder_decoder:
        t = max(8, S // cfg.target_ratio) if mode == "train" else 8
        t = min(t, encdec.WHISPER_MAX_TARGET)
        batch = {"frames": torch.zeros((B, S, cfg.d_model), dtype=dt,
                                       device=device), "tokens": ints(t)}
    elif cfg.n_prefix_embeds and mode in ("train", "prefill"):
        p = min(cfg.n_prefix_embeds, S // 2)
        batch = {"prefix_embeds": torch.zeros((B, p, cfg.d_model), dtype=dt,
                                              device=device),
                 "tokens": ints(S - p)}
    else:
        batch = {"tokens": ints(S)}
    if mode == "train":
        batch["labels"] = ints(batch["tokens"].shape[1])
    return batch


# ---------------------------------------------------------------------------
# Weight conversion: the same keys, shapes and layouts, no transposes
# ---------------------------------------------------------------------------

def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """A JAX parameter pytree (numpy or JAX arrays) -> the port's params,
    built by walking the JAX tree, so its lists (hymba's ``blocks``, an MoE
    model's ``prefix`` blocks) stay lists in JAX's leaf order. Empty
    containers (a dense model's ``prefix: []``) carry no leaves and are
    dropped."""
    return T.tree_map(lambda a: _to_tensor(a, device).requires_grad_(),
                      _drop_empty(tree))


def _drop_empty(tree):
    if isinstance(tree, dict):
        out = {k: _drop_empty(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if not (isinstance(v, (dict, list, tuple)) and not v)}
    if isinstance(tree, (list, tuple)):
        return [_drop_empty(v) for v in tree]
    return tree


def caches_from_jax(tree, device="cuda"):
    """A JAX cache tree (numpy or JAX arrays) -> the port's caches, the same
    keys (``prefix``, empty or one cache a dense prefix block, included)."""
    return T.tree_map(lambda a: _to_tensor(a, device), tree)


def caches_to_numpy(caches) -> dict:
    """The port's caches -> the same tree of numpy arrays."""
    return T.tree_map(tensor_to_numpy, caches)


def params_to_numpy(params) -> dict:
    """The port's params -> a nested dict of numpy arrays (bfloat16 as
    ``ml_dtypes.bfloat16`` where numpy has it, else the uint16 bits)."""
    return T.tree_map(tensor_to_numpy, params)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    return t.numpy()
