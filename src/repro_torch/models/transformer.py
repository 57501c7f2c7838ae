"""Decoder-only LM, dense and hybrid families: the port of the JAX
package's ``models/transformer.py`` for training (dense), prefill and
decode (both).

The parameter tree has exactly the JAX pytree's leaves: ``embed_tokens``
(padded_vocab, d), ``final_norm/scale``, ``lm_head`` (d, padded_vocab) and
the layers, with ``x @ W`` layouts. Where ``uses_scan(cfg)`` (deep
homogeneous dense stacks) they are the stack ``layers/...``, each leaf
stacked ``(L, ...)`` as ``jax.vmap(init_block)`` makes it; otherwise
(hymba: hybrid blocks, sliding windows) the list ``blocks``, one tree per
layer, each of its kind (``attn`` or ``hybrid``: attention and Mamba heads
side by side) and window. The forward walks the layers one by one, as
``lax.scan`` does; ``remat`` only saves memory and is left out. Caches are
the JAX trees: ``{"prefix": [], "layers": {"k", "v": (L, B, S, Hkv,
hd)}}`` for the stack, ``{"blocks": [{"attn": {"k", "v"}, "ssm": {"s"}},
...]}`` for hybrid blocks (a windowed layer's k/v a ring of min(seq,
window) slots); a decode step writes into them in place. Other families
raise ``ValueError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import gqa_cache_spec, gqa_decode, gqa_forward, init_gqa
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, dtype_of, embed_init, init_mlp,
                     init_norm)
from .ssm import init_mamba, mamba_decode, mamba_forward, mamba_state

# what each unported part of the model zoo waits for (ROADMAP.md, A10), by
# mode: "train" (loss_fn) or "serve" (init, prefill, decode, caches)
_UNPORTED = (
    (lambda c, m: c.is_encoder_decoder,
     "encoder-decoder (ROADMAP A10: encdec)"),
    (lambda c, m: c.is_moe, "MoE (ROADMAP A10: moe)"),
    (lambda c, m: c.family == "ssm",
     "xLSTM's SSM blocks, mLSTM and sLSTM (ROADMAP A10: ssm)"),
    (lambda c, m: c.family == "hybrid" and m == "train",
     "training of the SSM/hybrid blocks (ROADMAP A10: ssm training)"),
    (lambda c, m: c.attn_type == "mla",
     "MLA attention (ROADMAP A10: attention)"),
    (lambda c, m: c.family == "vlm" or c.n_prefix_embeds,
     "the VLM prefix (ROADMAP A10: transformer)"),
    (lambda c, m: m == "train" and not uses_scan(c),
     "training of unstacked or sliding-window layers (ROADMAP A10: "
     "transformer)"),
)


def check_supported(cfg: ModelConfig, mode: str = "serve") -> None:
    """Raise ``ValueError`` for any family the port does not run yet in
    ``mode`` ("train" or "serve")."""
    for test, what in _UNPORTED:
        if test(cfg, mode):
            raise ValueError(f"{cfg.name}: {what} is not ported yet; the "
                             f"port trains the dense GQA family and serves "
                             f"it and the hybrid family")


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    """Each layer's block kind: attn, or hybrid (attention and Mamba heads
    on the same input). xLSTM's m and s kinds come with xLSTM."""
    return ["hybrid" if cfg.family == "hybrid" else "attn"] * cfg.n_layers


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Each layer's sliding window, 0 for full (global) attention."""
    return [cfg.sliding_window if cfg.sliding_window
            and i not in cfg.global_attn_layers else 0
            for i in range(cfg.n_layers)]


def uses_scan(cfg: ModelConfig) -> bool:
    """Stacked layers only for deep, fully homogeneous attention stacks."""
    return (cfg.scan_layers and cfg.family in ("dense", "moe", "vlm")
            and not cfg.sliding_window)


def init_block(gen, cfg: ModelConfig, kind: str = "attn"):
    """kind: attn | hybrid (attention and Mamba heads on the same input)."""
    p = {"ln1": init_norm(cfg, gen.device), "attn": init_gqa(gen, cfg)}
    if kind == "hybrid":
        p["ssm"] = init_mamba(gen, cfg, d_out=cfg.d_model)
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
    if not uses_scan(cfg):
        params["blocks"] = [init_block(gen, cfg, kind)
                            for kind in _layer_kinds(cfg)]
        return params
    layers = None
    for i in range(cfg.n_layers):
        layers = _stack_into(layers, init_block(gen, cfg), i, cfg.n_layers)
    params["layers"] = layers
    return params


def block_forward(p, x, cfg: ModelConfig, mode: str = "train", cache=None,
                  pos=None, kind: str = "attn", window: int = 0):
    """One block; x (B, T, d). Returns (x, cache): the block's keys and
    values (train, prefill; a hybrid block adds the Mamba state,
    ``{"attn": {"k", "v"}, "ssm": {"s"}}``) or its cache, written in place
    (decode). A hybrid block adds the mean of its attention and Mamba
    heads, both reading the same normed input."""
    h = apply_norm(p["ln1"], x, cfg)
    hybrid = kind == "hybrid"
    if mode == "decode":
        a, nc = gqa_decode(p["attn"], h, cache["attn"] if hybrid else cache,
                           pos, cfg, window)
    else:
        a, nc = gqa_forward(p["attn"], h, cfg, window=window, mode=mode)
    if hybrid:
        if mode == "decode":
            s, sc = mamba_decode(p["ssm"], h, cache["ssm"], cfg)
        else:
            s, sc = mamba_forward(p["ssm"], h, cfg)
        x = x + 0.5 * (a + s)
        nc = {"attn": nc, "ssm": sc}
    else:
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
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode {mode!r} is train or prefill")
    check_supported(cfg, "train" if mode == "train" else "serve")
    x = _embed_inputs(params, batch, cfg)
    caches = None
    if uses_scan(cfg):
        stacked = None
        for i in range(cfg.n_layers):
            x, nc = block_forward(_layer(params["layers"], i), x, cfg, mode)
            if mode == "prefill":
                stacked = _stack_into(stacked, nc, i, cfg.n_layers)
        if mode == "prefill":
            caches = {"prefix": [], "layers": stacked}
    else:
        blocks = []
        for bp, kind, w in zip(params["blocks"], _layer_kinds(cfg),
                               _layer_windows(cfg)):
            x, nc = block_forward(bp, x, cfg, mode, kind=kind, window=w)
            if mode == "prefill":
                blocks.append(nc)
        if mode == "prefill":
            caches = {"blocks": blocks}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
    int). Writes each layer's k/v at ``pos`` (and each Mamba state) into
    ``caches`` in place and returns (logits (B, 1, V), caches)."""
    check_supported(cfg)
    x = F.embedding(token, params["embed_tokens"])
    if uses_scan(cfg):
        stack = caches["layers"]
        for i in range(cfg.n_layers):
            cache = {"k": stack["k"][i], "v": stack["v"][i]}
            x, _ = block_forward(_layer(params["layers"], i), x, cfg,
                                 "decode", cache=cache, pos=pos)
    else:
        for bp, c, kind, w in zip(params["blocks"], caches["blocks"],
                                  _layer_kinds(cfg), _layer_windows(cfg)):
            x, _ = block_forward(bp, x, cfg, "decode", cache=c, pos=pos,
                                 kind=kind, window=w)
    return _lm_logits(params, x, cfg), caches


def _one_cache(cfg: ModelConfig, kind: str, window: int, batch: int,
               seq: int, device):
    c = gqa_cache_spec(cfg, batch, seq, window, device)
    if kind == "hybrid":
        return {"attn": c, "ssm": mamba_state(cfg, batch, device)}
    return c


def init_caches(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Zero caches for a ``seq``-token context: the stacked (L, ...) tree,
    allocated (JAX only broadcasts one layer's), or one cache per block, a
    windowed layer's k/v min(seq, window) slots."""
    check_supported(cfg)
    if not uses_scan(cfg):
        return {"blocks": [_one_cache(cfg, kind, w, batch, seq, device)
                           for kind, w in zip(_layer_kinds(cfg),
                                              _layer_windows(cfg))]}
    one = gqa_cache_spec(cfg, batch, seq, 0, "meta")
    return {"prefix": [], "layers": {
        k: torch.zeros((cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                       device=device) for k, t in one.items()}}
