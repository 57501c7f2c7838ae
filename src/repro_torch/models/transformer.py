"""Decoder-only LM, dense family, train mode: the port of the JAX package's
``models/transformer.py``.

The parameter tree has exactly the JAX pytree's leaves: ``embed_tokens``
(padded_vocab, d), ``final_norm/scale``, ``lm_head`` (d, padded_vocab) and
the layer stack ``layers/...``, each leaf stacked ``(L, ...)`` as
``jax.vmap(init_block)`` makes it, with ``x @ W`` layouts. The forward
walks the stack layer by layer, as ``lax.scan`` does; ``remat`` only saves
memory and is left out. Other families raise ``ValueError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import gqa_forward, init_gqa
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


def _stack(blocks: list):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


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
    params["layers"] = _stack([init_block(gen, cfg)
                               for _ in range(cfg.n_layers)])
    return params


def block_forward(p, x, cfg: ModelConfig):
    """One attention block (train); x (B, T, d)."""
    a, _ = gqa_forward(p["attn"], apply_norm(p["ln1"], x, cfg), cfg)
    x = x + a
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x


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
        logits = torch.where(pad, logits, torch.tensor(
            -1e30, dtype=logits.dtype, device=x.device))
    return logits


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence train forward. Returns (logits, aux)."""
    check_supported(cfg)
    x = _embed_inputs(params, batch, cfg)
    for i in range(cfg.n_layers):
        x = block_forward(_layer(params["layers"], i), x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_logits(params, x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy. batch: tokens (B, T), labels (B, T)."""
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}
