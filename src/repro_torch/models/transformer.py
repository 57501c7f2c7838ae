"""Decoder-only LM, dense (GQA and MLA attention), MoE, hybrid and xLSTM
families: the port of the JAX package's ``models/transformer.py`` for
training, prefill and decode.

The parameter tree has exactly the JAX pytree's leaves: ``embed_tokens``
(padded_vocab, d), ``final_norm/scale``, ``lm_head`` (d, padded_vocab) and
the layers, with ``x @ W`` layouts. Where ``uses_scan(cfg)`` (deep
homogeneous dense stacks) they are the stack ``layers/...``, each leaf
stacked ``(L, ...)`` as ``jax.vmap(init_block)`` makes it (an MoE
model's first ``moe_dense_prefix`` blocks, dense, stand unstacked ahead of
it in the list ``prefix``, and the stack holds the MoE tail); otherwise
(hymba: hybrid blocks, sliding windows; xLSTM) the list ``blocks``, one
tree per layer, each of its kind and window: ``attn``, ``hybrid``
(attention and Mamba heads side by side), ``m`` (mLSTM) or ``s`` (sLSTM),
the last two a ``mix`` tree and no MLP. The forward walks the layers one
by one, as ``lax.scan`` does. In training, ``cfg.remat`` wraps each layer
in ``torch.utils.checkpoint``, a stacked layer as JAX checkpoints its scan
body and a block of the ``blocks`` list as JAX's ``jax.checkpoint`` per
block: the backward recomputes the layer's forward, which changes no
bit. An MoE block's FFN is ``moe`` in place of ``mlp`` (``models/moe.py``);
``forward`` sums the blocks' load-balance losses into its aux. Caches are
the JAX trees: ``{"prefix": [...], "layers": {"k", "v": (L, B, S, Hkv,
hd)}}`` for the stack (MLA: ``{"ckv": (L, B, S, r), "kr": (L, B, S,
rd)}``; ``prefix`` one cache a prefix block, empty without one),
``{"blocks": [...]}`` otherwise, each block's ``{"k", "v"}``,
``{"attn": {"k", "v"}, "ssm": {"s"}}`` (hybrid), ``{"C", "n"}`` (m) or
``{"c", "n", "h"}`` (s), a windowed layer's k/v a ring of min(seq,
window) slots; a decode step writes into them in place. A VLM (llava)
is the dense stack with its image embeddings, ``prefix_embeds``, ahead of
the tokens: every position after them, the rope positions of prefill and
each decode step's ``pos`` among them, counts them. The encoder-decoder
family is ``models/encdec.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import layer_gather as lg
from ..parallel.sharding import checkpoint_context
from .attention import (gqa_cache_spec, gqa_decode, gqa_forward, init_gqa,
                        init_mla, mla_cache_spec, mla_decode, mla_forward)
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, dtype_of, embed_init, init_mlp,
                     init_norm)
from .moe import init_moe, moe_forward
from .ssm import (init_mamba, init_mlstm, init_slstm, mamba_decode,
                  mamba_forward, mamba_state, mlstm_decode, mlstm_forward,
                  mlstm_state, slstm_decode, slstm_forward, slstm_state)

def _layer_kinds(cfg: ModelConfig) -> list[str]:
    """Each layer's block kind: attn, hybrid (attention and Mamba heads on
    the same input), or xLSTM's m and s by ``block_pattern``."""
    if cfg.family == "ssm":
        pat = cfg.block_pattern or ("m", "s")
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
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


def init_block(gen, cfg: ModelConfig, kind: str = "attn", moe: bool = False):
    """kind: attn | hybrid (attention and Mamba heads on the same input) |
    m | s (xLSTM's mixers, no MLP). ``moe``: the FFN is ``moe`` (an MoE
    layer) in place of ``mlp``."""
    p = {"ln1": init_norm(cfg, gen.device)}
    if kind in ("m", "s"):
        p["mix"] = (init_mlstm if kind == "m" else init_slstm)(gen, cfg)
        return p
    p["attn"] = (init_mla if cfg.attn_type == "mla" and kind == "attn"
                 else init_gqa)(gen, cfg)
    if kind == "hybrid":
        p["ssm"] = init_mamba(gen, cfg, d_out=cfg.d_model)
    if cfg.d_ff > 0:
        p["ln2"] = init_norm(cfg, gen.device)
        if moe:
            p["moe"] = init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg, cfg.d_ff)
    return p


def _stack_into(out, block, i: int, n: int):
    """Write ``block`` into slot ``i`` of the stacked tree ``out`` (made at
    i = 0 with ``n`` slots), taking its leaves out of ``block`` one by one:
    the stack never exists twice, as it would with one ``torch.stack`` over
    all the blocks, and of the block only the leaf being copied (a stack
    of one is the block's own leaves, viewed with a leading axis: kimi-k2's
    MoE layer is 33.8 GB)."""
    if isinstance(block, dict):
        out = {} if out is None else out
        for k in list(block):
            out[k] = _stack_into(out.get(k), block.pop(k), i, n)
        return out
    if n == 1:
        return block[None]
    if out is None:
        out = block.new_empty((n,) + tuple(block.shape))
    out[i] = block
    return out


def _n_prefix(cfg: ModelConfig) -> int:
    """The dense blocks ahead of an MoE model's MoE layers."""
    return cfg.moe_dense_prefix if cfg.is_moe else 0


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """The parameter tree, drawn from ``gen`` on ``gen.device``."""
    dt = dtype_of(cfg)
    params = {
        "embed_tokens": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt),
        "final_norm": init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       dt)
    n_prefix = _n_prefix(cfg)
    if not uses_scan(cfg):
        params["blocks"] = [
            init_block(gen, cfg, kind, moe=cfg.is_moe and i >= n_prefix)
            for i, kind in enumerate(_layer_kinds(cfg))]
        return params
    if n_prefix:
        params["prefix"] = [init_block(gen, cfg) for _ in range(n_prefix)]
    layers, tail = None, cfg.n_layers - n_prefix
    for i in range(tail):
        layers = _stack_into(layers, init_block(gen, cfg, moe=cfg.is_moe),
                             i, tail)
    params["layers"] = layers
    return params


def block_forward(p, x, cfg: ModelConfig, mode: str = "train", cache=None,
                  pos=None, kind: str = "attn", window: int = 0,
                  path: str = "layers"):
    """One block; x (B, T, d). Returns (x, cache, aux): the block's keys
    and values (train, prefill; a hybrid block adds the Mamba state,
    ``{"attn": {"k", "v"}, "ssm": {"s"}}``; an xLSTM block its final
    state) or its cache, written in place (decode), and an MoE block's
    load-balance loss (None for any other block). A hybrid block adds the
    mean of its attention and Mamba heads, both reading the same normed
    input. ``path`` is the block's place in the parameter tree: over a
    mesh its shards are gathered here (``layer_gather.layer``), and the
    GQA attention and the MLP split over ``model`` where the plan says so
    (``tp_in``/``tp_out``); without a plan both are the identity."""
    p = lg.layer(p, path)
    h = apply_norm(p["ln1"], x, cfg)
    if kind in ("m", "s"):
        fwd, dec = ((mlstm_forward, mlstm_decode) if kind == "m"
                    else (slstm_forward, slstm_decode))
        a, nc = (dec(p["mix"], h, cache, cfg) if mode == "decode"
                 else fwd(p["mix"], h, cfg))
        return x + a, nc, None
    hybrid = kind == "hybrid"
    if cfg.attn_type == "mla" and not hybrid:
        a, nc = (mla_decode(p["attn"], h, cache, pos, cfg) if mode == "decode"
                 else mla_forward(p["attn"], h, cfg, mode=mode))
    elif mode == "decode":
        a, nc = gqa_decode(p["attn"], h, cache["attn"] if hybrid else cache,
                           pos, cfg, window)
    else:
        a, nc = gqa_forward(p["attn"], lg.tp_in(h, "attn"), cfg,
                            window=window, mode=mode)
        a = lg.tp_out(a, "attn")
    if hybrid:
        if mode == "decode":
            s, sc = mamba_decode(p["ssm"], h, cache["ssm"], cfg)
        else:
            s, sc = mamba_forward(p["ssm"], h, cfg)
        x = x + 0.5 * (a + s)
        nc = {"attn": nc, "ssm": sc}
    else:
        x = x + a
    aux = None
    if "moe" in p:
        y, aux = moe_forward(p["moe"], apply_norm(p["ln2"], x, cfg), cfg)
        x = x + y
    elif "mlp" in p:
        h = lg.tp_in(apply_norm(p["ln2"], x, cfg), "mlp")
        x = x + lg.tp_out(apply_mlp(p["mlp"], h, cfg), "mlp")
    return x, nc, aux


def _train_block(p, x, cfg: ModelConfig, kind: str, window: int,
                 path: str = "layers"):
    """A block's output and aux in train mode (what ``checkpoint``
    recomputes, the gather of its shards included)."""
    x, _, aux = block_forward(p, x, cfg, "train", kind=kind, window=window,
                              path=path)
    return x, aux


def _add_aux(aux, a):
    return aux if a is None else aux + a


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params, tokens):
    """The token embeddings: over a vocab-parallel mesh this rank's rows
    looked up and summed over ``model`` (``layer_gather.embed``)."""
    if lg.vocab() is not None:
        return lg.embed(params["embed_tokens"], tokens)
    return F.embedding(tokens, lg.layer(params["embed_tokens"],
                                       "embed_tokens"))


def _embed_inputs(params, batch, cfg: ModelConfig):
    """tokens (B, T) -> (B, T, d); a VLM's ``prefix_embeds`` (B, P, d),
    cast to the embedding dtype, come ahead of them (B, P + T, d)."""
    x = _embed(params, batch["tokens"])
    if cfg.n_prefix_embeds and "prefix_embeds" in batch:
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    return x


def _lm_logits(params, x, cfg: ModelConfig):
    """The logits, over a vocab-parallel mesh this rank's columns."""
    x = apply_norm(lg.layer(params["final_norm"], "final_norm"), x, cfg)
    tied = cfg.tie_embeddings
    shard = params["embed_tokens" if tied else "lm_head"]
    v = lg.vocab()
    if v is not None:
        logits = lg.head(x, shard, tied)
    else:
        head = lg.layer(shard, "embed_tokens" if tied else "lm_head")
        logits = x @ (head.T if tied else head)
    if cfg.padded_vocab != cfg.vocab:  # mask padding columns out of softmax
        lo = 0 if v is None else v[1]
        pad = torch.arange(lo, lo + logits.shape[-1],
                           device=x.device) < cfg.vocab
        logits = torch.where(pad, logits, -1e30)   # in logits' dtype
    return logits


def forward(params, batch, cfg: ModelConfig, mode: str = "train"):
    """Full-sequence forward (train or prefill). Returns (logits, aux,
    caches); caches are None in train mode."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode {mode!r} is train or prefill")
    x = _embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = None
    if uses_scan(cfg):
        # the dense prefix blocks unstacked, as JAX runs them (no remat)
        prefix = []
        for j, bp in enumerate(params.get("prefix", [])):
            x, nc, a = block_forward(bp, x, cfg, mode, path=f"prefix/{j}")
            aux = _add_aux(aux, a)
            prefix.append(nc)
        stacked, tail = None, cfg.n_layers - _n_prefix(cfg)
        for i in range(tail):
            lp = _layer(params["layers"], i)
            if mode == "train" and cfg.remat:
                x, a = checkpoint(_train_block, lp, x, cfg, "attn", 0,
                                  "layers", use_reentrant=False,
                                  context_fn=checkpoint_context)
                aux = _add_aux(aux, a)
                continue
            x, nc, a = block_forward(lp, x, cfg, mode)
            aux = _add_aux(aux, a)
            if mode == "prefill":
                stacked = _stack_into(stacked, nc, i, tail)
        if mode == "prefill":
            caches = {"prefix": prefix, "layers": stacked}
    else:
        blocks = []
        for j, (bp, kind, w) in enumerate(zip(params["blocks"],
                                              _layer_kinds(cfg),
                                              _layer_windows(cfg))):
            if mode == "train" and cfg.remat:
                x, a = checkpoint(_train_block, bp, x, cfg, kind, w,
                                  f"blocks/{j}", use_reentrant=False,
                                  context_fn=checkpoint_context)
                aux = _add_aux(aux, a)
                continue
            x, nc, a = block_forward(bp, x, cfg, mode, kind=kind, window=w,
                                     path=f"blocks/{j}")
            aux = _add_aux(aux, a)
            if mode == "prefill":
                blocks.append(nc)
        if mode == "prefill":
            caches = {"blocks": blocks}
    return _lm_logits(params, x, cfg), aux, caches


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy (+ 0.01 x the MoE aux). batch: tokens (B,
    T), labels (B, T); a VLM's prefix positions have no labels, and their
    logits are dropped."""
    logits, aux, _ = forward(params, batch, cfg)
    if cfg.n_prefix_embeds and "prefix_embeds" in batch:
        logits = logits[:, batch["prefix_embeds"].shape[1]:, :]
    nll = _nll(logits, batch["labels"])
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def _nll(logits, labels):
    """The mean cross-entropy of ``labels`` under ``logits``, in float32,
    over the labels >= 0 (a negative label is masked); over a
    vocab-parallel mesh ``layer_gather.vocab_nll``."""
    if lg.vocab() is not None:
        return lg.vocab_nll(logits, labels)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def prefill(params, batch, cfg: ModelConfig):
    """Returns (last-position logits (B, 1, V), caches) for decode."""
    logits, _, caches = forward(params, batch, cfg, mode="prefill")
    return logits[:, -1:, :], caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step. token: (B, 1) int; pos: the token's position (an
    int). Writes each layer's k/v or latent at ``pos`` (and each recurrent
    state) into ``caches`` in place and returns (logits (B, 1, V),
    caches). A VLM's ``pos`` counts its prefix positions."""
    x = _embed(params, token)
    if uses_scan(cfg):
        for j, (bp, c) in enumerate(zip(params.get("prefix", []),
                                        caches["prefix"])):
            x, _, _ = block_forward(bp, x, cfg, "decode", cache=c, pos=pos,
                                    path=f"prefix/{j}")
        stack = caches["layers"]
        for i in range(cfg.n_layers - _n_prefix(cfg)):
            cache = {n: c[i] for n, c in stack.items()}
            x, _, _ = block_forward(_layer(params["layers"], i), x, cfg,
                                    "decode", cache=cache, pos=pos)
    else:
        for j, (bp, c, kind, w) in enumerate(zip(
                params["blocks"], caches["blocks"], _layer_kinds(cfg),
                _layer_windows(cfg))):
            x, _, _ = block_forward(bp, x, cfg, "decode", cache=c, pos=pos,
                                    kind=kind, window=w, path=f"blocks/{j}")
    return _lm_logits(params, x, cfg), caches


def _one_cache(cfg: ModelConfig, kind: str, window: int, batch: int,
               seq: int, device):
    if kind in ("m", "s"):
        return (mlstm_state if kind == "m" else slstm_state)(cfg, batch,
                                                             device)
    if cfg.attn_type == "mla" and kind == "attn":
        return mla_cache_spec(cfg, batch, seq, device)
    c = gqa_cache_spec(cfg, batch, seq, window, device)
    if kind == "hybrid":
        return {"attn": c, "ssm": mamba_state(cfg, batch, device)}
    return c


def init_caches(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Zero caches for a ``seq``-token context: one cache a dense prefix
    block and the stacked (L, ...) tree of the rest, allocated (JAX only
    broadcasts one layer's), or one cache per block, a windowed layer's
    k/v min(seq, window) slots."""
    if not uses_scan(cfg):
        return {"blocks": [_one_cache(cfg, kind, w, batch, seq, device)
                           for kind, w in zip(_layer_kinds(cfg),
                                              _layer_windows(cfg))]}
    one = _one_cache(cfg, "attn", 0, batch, seq, "meta")
    n_prefix = _n_prefix(cfg)
    return {"prefix": [_one_cache(cfg, "attn", 0, batch, seq, device)
                       for _ in range(n_prefix)],
            "layers": {k: torch.zeros((cfg.n_layers - n_prefix,)
                                      + tuple(t.shape), dtype=t.dtype,
                                      device=device)
                       for k, t in one.items()}}
