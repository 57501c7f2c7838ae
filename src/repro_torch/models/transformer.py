"""Decoder-only LM, dense family: the port of the JAX package's
``models/transformer.py`` for training, prefill and decode.

The parameter tree has exactly the JAX pytree's leaves: ``embed_tokens``
(padded_vocab, d), ``final_norm/scale``, ``lm_head`` (d, padded_vocab) and
the layer stack ``layers/...``, each leaf stacked ``(L, ...)`` as
``jax.vmap(init_block)`` makes it, with ``x @ W`` layouts. The forward
walks the stack layer by layer, as ``lax.scan`` does; ``remat`` only saves
memory and is left out. Caches are the JAX tree of the stacked stack,
``{"prefix": [], "layers": {"k", "v": (L, B, S, Hkv, hd)}}``; a decode step
writes into them in place. Other families raise ``ValueError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import gqa_cache_spec, gqa_decode, gqa_forward, init_gqa
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, dtype_of, embed_init, init_mlp,
                     init_norm)

# what each unported part of the model zoo waits for (ROADMAP.md, A10)
_UNPORTED = (
    (lambda c: c.is_encoder_decoder, "encoder-decoder (ROADMAP A10: encdec)"),
    (lambda c: c.is_moe, "MoE (ROADMAP A10: moe)"),
    (lambda c: c.family in ("ssm", "hybrid"),
     "SSM/hybrid blocks (ROADMAP A10: ssm, kernel B6)"),
    (lambda c: c.attn_type == "mla", "MLA attention (ROADMAP A10: attention)"),
    (lambda c: c.family == "vlm" or c.n_prefix_embeds,
     "the VLM prefix (ROADMAP A10: transformer)"),
    (lambda c: c.sliding_window or not c.scan_layers,
     "unstacked or sliding-window layers (ROADMAP A10: transformer)"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for any family the port does not run yet."""
    for test, what in _UNPORTED:
        if test(cfg):
            raise ValueError(f"{cfg.name}: {what} is not ported yet; the "
                             f"port runs the dense GQA family")


def init_block(gen, cfg: ModelConfig):
    p = {"ln1": init_norm(cfg, gen.device), "attn": init_gqa(gen, cfg)}
    if cfg.d_ff > 0:
        p["ln2"] = init_norm(cfg, gen.device)
        p["mlp"] = init_mlp(gen, cfg, cfg.d_ff)
    return p


def _stack_into(out, block, i: int, n: int):
    """Write ``block`` into slot ``i`` of the stacked tree ``out`` (made at
    i = 0 with ``n`` slots): the stack never exists twice, as it would with
    one ``torch.stack`` over all the blocks."""
    if isinstance(block, dict):
        out = {} if out is None else out
        for k, v in block.items():
            out[k] = _stack_into(out.get(k), v, i, n)
        return out
    if out is None:
        out = block.new_empty((n,) + tuple(block.shape))
    out[i] = block
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """The parameter tree, drawn from ``gen`` on ``gen.device``."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    params = {
        "embed_tokens": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt),
        "final_norm": init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       dt)
    layers = None
    for i in range(cfg.n_layers):
        layers = _stack_into(layers, init_block(gen, cfg), i, cfg.n_layers)
    params["layers"] = layers
    return params


def block_forward(p, x, cfg: ModelConfig, mode: str = "train", cache=None,
                  pos=None):
    """One attention block; x (B, T, d). Returns (x, {"k", "v"}): the
    block's keys and values (train, prefill) or its cache, written in place
    (decode)."""
    h = apply_norm(p["ln1"], x, cfg)
    if mode == "decode":
        a, nc = gqa_decode(p["attn"], h, cache, pos, cfg)
    else:
        a, nc = gqa_forward(p["attn"], h, cfg, mode=mode)
    x = x + a
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, nc


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed_inputs(params, batch, cfg: ModelConfig):
    return F.embedding(batch["tokens"], params["embed_tokens"])


def _lm_logits(params, x, cfg: ModelConfig):
    x = apply_norm(params["final_norm"], x, cfg)
    head = (params["embed_tokens"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab:  # mask padding columns out of softmax
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(pad, logits, -1e30)   # in logits' dtype
    return logits


def forward(params, batch, cfg: ModelConfig, mode: str = "train"):
    """Full-sequence forward (train or prefill). Returns (logits, aux,
    caches); caches are None in train mode."""
    check_supported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode {mode!r} is train or prefill")
    x = _embed_inputs(params, batch, cfg)
    stacked = None
    for i in range(cfg.n_layers):
        x, nc = block_forward(_layer(params["layers"], i), x, cfg, mode)
        if mode == "prefill":
            stacked = _stack_into(stacked, nc, i, cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = None if stacked is None else {"prefix": [], "layers": stacked}
    return _lm_logits(params, x, cfg), aux, caches


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy. batch: tokens (B, T), labels (B, T)."""
    logits, aux, _ = forward(params, batch, cfg)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def prefill(params, batch, cfg: ModelConfig):
    """Returns (last-position logits (B, 1, V), caches) for decode."""
    logits, _, caches = forward(params, batch, cfg, mode="prefill")
    return logits[:, -1:, :], caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step. token: (B, 1) int; pos: the token's position (an
    int). Writes each layer's k/v at ``pos`` into ``caches`` in place and
    returns (logits (B, 1, V), caches)."""
    check_supported(cfg)
    x = F.embedding(token, params["embed_tokens"])
    stack = caches["layers"]
    for i in range(cfg.n_layers):
        cache = {"k": stack["k"][i], "v": stack["v"][i]}
        x, _ = block_forward(_layer(params["layers"], i), x, cfg, "decode",
                             cache=cache, pos=pos)
    return _lm_logits(params, x, cfg), caches


def init_caches(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Zero caches for a ``seq``-token context: the stacked (L, ...) tree,
    allocated (JAX only broadcasts one layer's)."""
    check_supported(cfg)
    one = gqa_cache_spec(cfg, batch, seq, 0, "meta")
    return {"prefix": [], "layers": {
        k: torch.zeros((cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                       device=device) for k, t in one.items()}}
