"""Whisper-style encoder-decoder (the audio family): the port of the JAX
package's ``models/encdec.py`` for training, prefill and decode.

The mel/conv frontend is a stub, as in JAX: the batch carries precomputed
frame embeddings ``frames`` (B, S, d). Both sides add sinusoidal absolute
positions (built in numpy float64 and cast to the model dtype, bit for bit
JAX's table), LayerNorm, a GELU MLP, no rope. The parameter tree is the JAX
pytree: ``embed_tokens`` (padded_vocab, d; the head is tied),
``enc_layers`` and ``dec_layers`` stacked (L, ...) with ``x @ W``
layouts, ``enc_norm`` and ``final_norm``. Caches are JAX's ``{"dec":
{"self": {"k", "v"}, "cross": {"k", "v"}}}``, each stacked (L, B, S, Hkv,
hd): the decoder's self-attention cache is ``WHISPER_MAX_TARGET`` slots,
the cross-attention cache holds the encoder's keys and values, as long as
the frames.

Attention by mode: ``train`` spells JAX's ``sdpa`` (``sdpa_blocked``
where the sequence tiles, as ``attention.gqa_forward``; autograd runs
through them, ``cfg.remat`` checkpoints each layer); ``prefill`` runs the
flash kernel, non-causal for the encoder and for cross attention (T
prompt rows over S frames), causal for the decoder's self-attention;
``decode`` writes the token's k/v into the self cache at ``pos`` in place
and runs the split decode over the cache prefix ``[:pos + 1]`` (JAX masks
``arange(448) <= pos``) and over the whole cross cache. A decode step
allocates no cache.

JAX's ``prefill`` returns self caches only T slots long; its
``decode_step`` would clamp a write at ``pos = T`` into slot T - 1
(ROADMAP C26). ``api.decode_caches`` hands the prefill's self k/v over
into ``init_caches``' 448 slots at [0, T), and the cross caches as they
are.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import flash_attention_gqa
from ..parallel import layer_gather as lg
from ..parallel.sharding import checkpoint_context
from .attention import (_pick_block, _scale, block_decode, causal_mask,
                        sdpa, sdpa_blocked)
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, dense_init, dtype_of, embed_init,
                     init_mlp, init_norm)
from .transformer import _layer, _nll, _stack_into

WHISPER_MAX_TARGET = 448


def sinusoid(T: int, d: int, dtype: torch.dtype, device="cpu"):
    """The (T, d) table [sin | cos] of positions over 10000^(2i / d), built
    in numpy float64 and cast to ``dtype`` on ``device``."""
    pos = np.arange(T)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def _positions(T: int, d: int, dtype: torch.dtype, device, tables):
    """``sinusoid(T, d, dtype, device)``, kept in ``tables`` when it is a
    dict: each function of ``api`` owns one, so a table is built once per
    function, as JAX's jit folds it into a constant (32,768 frames are 42
    M sines and cosines on the host)."""
    if tables is None:
        return sinusoid(T, d, dtype, device)
    key = (T, d, dtype, torch.device(device))
    if key not in tables:
        tables[key] = sinusoid(T, d, dtype, device)
    return tables[key]


def _init_xattn(gen, cfg: ModelConfig):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    return {"w_q": dense_init(gen, (d, H * hd), dt),
            "w_k": dense_init(gen, (d, Hkv * hd), dt),
            "w_v": dense_init(gen, (d, Hkv * hd), dt),
            "w_o": dense_init(gen, (H * hd, d), dt)}


def _attend(p, xq, k, v, cfg: ModelConfig, causal: bool, mode: str):
    """xq (B, T, d) over k, v (B, S, Hkv, hd) -> (B, T, d): ``sdpa``
    (train), else the flash kernel (T = 1: the split decode)."""
    B, T, _ = xq.shape
    q = (xq @ p["w_q"]).reshape(B, T, cfg.n_heads, cfg.hd)
    scale = _scale(cfg.hd)
    if mode != "train":
        out = flash_attention_gqa(q, k, v, scale, causal=causal)
    else:
        S = k.shape[1]
        block = _pick_block(T, S)
        if block:
            out = sdpa_blocked(q, k, v, scale, causal=causal, block=block)
        else:
            mask = (causal_mask(T, S, device=xq.device) if causal else
                    torch.ones((T, S), dtype=torch.bool, device=xq.device))
            out = sdpa(q, k, v, mask[None], scale)
    return out.reshape(B, T, -1) @ p["w_o"]


def _kv(p, x, cfg: ModelConfig):
    B, S, _ = x.shape
    k = (x @ p["w_k"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["w_v"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return k, v


def _init_enc_block(gen, cfg: ModelConfig):
    dev = gen.device
    return {"ln1": init_norm(cfg, dev), "attn": _init_xattn(gen, cfg),
            "ln2": init_norm(cfg, dev), "mlp": init_mlp(gen, cfg, cfg.d_ff)}


def _init_dec_block(gen, cfg: ModelConfig):
    dev = gen.device
    return {"ln1": init_norm(cfg, dev), "self": _init_xattn(gen, cfg),
            "lnx": init_norm(cfg, dev), "cross": _init_xattn(gen, cfg),
            "ln2": init_norm(cfg, dev), "mlp": init_mlp(gen, cfg, cfg.d_ff)}


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """The parameter tree, drawn from ``gen`` on ``gen.device``; the
    encoder and decoder layers stacked (L, ...)."""
    params = {"embed_tokens": embed_init(gen, (cfg.padded_vocab,
                                               cfg.d_model), dtype_of(cfg))}
    for key, n, init in (("enc_layers", cfg.n_encoder_layers,
                          _init_enc_block),
                         ("dec_layers", cfg.n_layers, _init_dec_block)):
        stack = None
        for i in range(n):
            stack = _stack_into(stack, init(gen, cfg), i, n)
        params[key] = stack
    params["enc_norm"] = init_norm(cfg, gen.device)
    params["final_norm"] = init_norm(cfg, gen.device)
    return params


def _enc_block(p, x, cfg: ModelConfig, mode: str):
    p = lg.layer(p, "enc_layers")
    h = apply_norm(p["ln1"], x, cfg)
    k, v = _kv(p["attn"], h, cfg)
    x = x + _attend(p["attn"], h, k, v, cfg, False, mode)
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def encode(params, frames, cfg: ModelConfig, mode: str = "train",
           tables=None):
    """frames (B, S, d) -> the encoder's output (B, S, d): the frames cast
    to the model dtype plus the positions' table (one rounding in that
    dtype, as JAX adds them), then the stacked layers, non-causal."""
    B, S, d = frames.shape
    dt = dtype_of(cfg)
    x = frames.to(dt) + _positions(S, d, dt, frames.device, tables)[None]
    for i in range(cfg.n_encoder_layers):
        p = _layer(params["enc_layers"], i)
        if mode == "train" and cfg.remat:
            x = checkpoint(_enc_block, p, x, cfg, mode, use_reentrant=False,
                           context_fn=checkpoint_context)
        else:
            x = _enc_block(p, x, cfg, mode)
    return apply_norm(lg.layer(params["enc_norm"], "enc_norm"), x, cfg)


def _dec_block(p, x, enc_out, cfg: ModelConfig, mode: str):
    """One decoder layer over the whole prompt (train, prefill). Returns
    (x, its self and cross keys and values)."""
    p = lg.layer(p, "dec_layers")
    h = apply_norm(p["ln1"], x, cfg)
    k1, v1 = _kv(p["self"], h, cfg)
    x = x + _attend(p["self"], h, k1, v1, cfg, True, mode)
    h = apply_norm(p["lnx"], x, cfg)
    ke, ve = _kv(p["cross"], enc_out, cfg)
    x = x + _attend(p["cross"], h, ke, ve, cfg, False, mode)
    x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, {"self": {"k": k1, "v": v1}, "cross": {"k": ke, "v": ve}}


def _train_dec_block(p, x, enc_out, cfg: ModelConfig):
    return _dec_block(p, x, enc_out, cfg, "train")[0]


def _decode_layer(p, x, cache, pos: int, cfg: ModelConfig):
    """One decoder layer of a decode step: the token's self k/v written at
    ``pos`` in place, attention over the self prefix and all the cross
    cache. Where the ``model`` ranks of a mesh hold blocks of a cache's
    positions (``layer_gather.decode_block``), ``pos`` is the sequence's
    own: the rank whose self block holds it writes there."""
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    p = lg.layer(p, "dec_layers")
    h = apply_norm(p["ln1"], x, cfg)
    k1, v1 = _kv(p["self"], h, cfg)
    start = lg.decode_block(sk.shape[1])
    at = pos if start is None else pos - start
    if start is None or 0 <= at < sk.shape[1]:
        sk[:, at] = k1[:, 0]
        sv[:, at] = v1[:, 0]
    x = x + _decode_attend(p["self"], h, sk, sv, pos + 1, cfg)
    h = apply_norm(p["lnx"], x, cfg)
    x = x + _decode_attend(p["cross"], h, cache["cross"]["k"],
                           cache["cross"]["v"], None, cfg)
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def _decode_attend(p, h, k, v, n: int | None, cfg: ModelConfig):
    """h (B, 1, d) over the first ``n`` positions of the cache k, v (all
    of them where ``n`` is None); where the ``model`` ranks hold blocks of
    its positions, over the filled part of this rank's block, merged by
    log-sum-exp (``attention.block_decode``)."""
    start = lg.decode_block(k.shape[1])
    if start is None:
        return _attend(p, h, k[:, :n], v[:, :n], cfg, False, "decode")
    B = h.shape[0]
    q = (h @ p["w_q"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    n = k.shape[1] if n is None else n - start
    return (block_decode(q, k, v, n, _scale(cfg.hd)).reshape(B, 1, -1)
            @ p["w_o"])


def _decode_blocks(params, x, enc_out, cfg: ModelConfig, mode: str,
                   caches=None, pos=None):
    """The decoder stack. train: (x, None); prefill: (x, the stacked self
    and cross caches, T and S long); decode: (x, ``caches``, written in
    place at ``pos``)."""
    L = cfg.n_layers
    if mode == "decode":
        for i in range(L):
            x = _decode_layer(_layer(params["dec_layers"], i), x,
                              _layer(caches, i), pos, cfg)
        return x, caches
    stacked = None
    for i in range(L):
        p = _layer(params["dec_layers"], i)
        if mode == "train" and cfg.remat:
            x = checkpoint(_train_dec_block, p, x, enc_out, cfg,
                           use_reentrant=False,
                           context_fn=checkpoint_context)
            continue
        x, nc = _dec_block(p, x, enc_out, cfg, mode)
        if mode == "prefill":
            stacked = _stack_into(stacked, nc, i, L)
    return x, stacked


def _logits(params, x, cfg: ModelConfig):
    """The tied head; the padded vocab columns set to -1e30."""
    logits = x @ lg.layer(params["embed_tokens"], "embed_tokens").T
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(pad, logits, -1e30)   # in logits' dtype
    return logits


def _head(params, x, cfg: ModelConfig):
    """The final norm, then the tied head."""
    norm = lg.layer(params["final_norm"], "final_norm")
    return _logits(params, apply_norm(norm, x, cfg), cfg)


def _embed_tokens(params, tokens, cfg: ModelConfig, tables=None):
    T = tokens.shape[1]
    dt = dtype_of(cfg)
    return (F.embedding(tokens, lg.layer(params["embed_tokens"],
                                        "embed_tokens"))
            + _positions(T, cfg.d_model, dt, tokens.device, tables)[None])


def loss_fn(params, batch, cfg: ModelConfig, tables=None):
    """Next-token cross-entropy of the decoder. batch: frames (B, S, d),
    tokens (B, T), labels (B, T). ``tables``: see :func:`_positions`."""
    enc_out = encode(params, batch["frames"], cfg, "train", tables)
    x = _embed_tokens(params, batch["tokens"], cfg, tables)
    x, _ = _decode_blocks(params, x, enc_out, cfg, "train")
    logits = _head(params, x, cfg)
    nll = _nll(logits, batch["labels"])
    return nll, {"nll": nll, "aux": torch.zeros((), device=nll.device)}


def prefill(params, batch, cfg: ModelConfig, tables=None):
    """Encode the frames and run the decoder over the prompt: (last-position
    logits (B, 1, V), {"dec": caches}), the self caches T slots long.
    ``tables``: see :func:`_positions`."""
    enc_out = encode(params, batch["frames"], cfg, "prefill", tables)
    x = _embed_tokens(params, batch["tokens"], cfg, tables)
    x, caches = _decode_blocks(params, x, enc_out, cfg, "prefill")
    logits = _head(params, x, cfg)
    return logits[:, -1:, :], {"dec": caches}


def decode_step(params, caches, token, pos: int, cfg: ModelConfig,
                tables=None):
    """One decode step. token: (B, 1); pos: its position (a host int below
    ``WHISPER_MAX_TARGET``). Writes each layer's self k/v at ``pos`` into
    ``caches`` in place and returns (logits (B, 1, V), caches).
    ``tables``: see :func:`_positions`."""
    pos = int(pos)
    slots = lg.whole_length(caches["dec"]["self"]["k"].shape[2])
    if not 0 <= pos < slots:
        raise ValueError(f"encdec decode: position {pos} outside a self "
                         f"cache of {slots}")
    dt = dtype_of(cfg)
    posv = _positions(WHISPER_MAX_TARGET, cfg.d_model, dt, token.device,
                      tables)
    x = (F.embedding(token, lg.layer(params["embed_tokens"], "embed_tokens"))
         + posv[pos])
    x, _ = _decode_blocks(params, x, None, cfg, "decode",
                          caches=caches["dec"], pos=pos)
    logits = _head(params, x, cfg)
    return logits, caches


def init_caches(cfg: ModelConfig, batch: int, enc_len: int, device="cuda"):
    """Zero caches: self (L, batch, 448, Hkv, hd) and cross (L, batch,
    ``enc_len``, Hkv, hd), k and v each its own tensor (a decode writes
    into them). A serving loop that hands the prefill's cross caches over
    passes ``enc_len`` 0."""
    dt = dtype_of(cfg)
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((L, batch, s, hkv, hd), dtype=dt, device=device)

    return {"dec": {"self": {"k": zeros(WHISPER_MAX_TARGET),
                             "v": zeros(WHISPER_MAX_TARGET)},
                    "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}}
