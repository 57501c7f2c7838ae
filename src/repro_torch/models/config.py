"""Model configuration schema for the architecture zoo."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0               # 0 -> d_model // n_heads
    # ---- attention -------------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    global_attn_layers: tuple = ()  # hybrid: layers with full attention
    # ---- MLA (deepseek/minicpm) -------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # ---- MLP ---------------------------------------------------------------
    mlp_type: str = "swiglu"        # swiglu | gelu | relu2
    # ---- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_dense_prefix: int = 0       # first layers use a dense MLP
    capacity_factor: float = 1.25
    # ---- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0
    d_inner_mult: float = 2.0       # mamba inner expansion
    block_pattern: tuple = ()       # xlstm: ("m","s") repeated
    chunk_size: int = 256           # chunkwise-parallel scan chunk
    # ---- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    target_ratio: int = 8           # train target len = seq // target_ratio
    # ---- frontends (stubs) ----------------------------------------------------
    frontend: str = ""              # "" | vision_stub | audio_stub
    n_prefix_embeds: int = 0        # VLM: image tokens given as embeddings
    # ---- misc ------------------------------------------------------------------
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True        # lax.scan over homogeneous layer stack
    decode_absorb: bool = True      # MLA: absorbed (latent) decode path

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded so the vocab dim shards evenly (TP=16);
        padded logits are masked out of the loss/softmax."""
        mult = 1024 if self.vocab >= 1024 else 16
        return ((self.vocab + mult - 1) // mult) * mult

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (bounded attention state)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=128,
            vocab=256,
            head_dim=16 if self.head_dim else 0,
        )
        if self.is_moe:
            small.update(n_experts=4, top_k=2, d_ff_expert=64,
                         n_shared_experts=min(self.n_shared_experts, 1),
                         moe_dense_prefix=min(self.moe_dense_prefix, 1))
        if self.attn_type == "mla":
            small.update(kv_lora_rank=32, q_lora_rank=32, qk_nope_dim=16,
                         qk_rope_dim=8, v_head_dim=16)
        if self.is_encoder_decoder:
            small.update(n_encoder_layers=2)
        if self.block_pattern:
            small.update(block_pattern=("m", "s"))
        if self.sliding_window:
            small.update(sliding_window=32)
        if self.global_attn_layers:
            small.update(global_attn_layers=(0,))
        if self.n_prefix_embeds:
            small.update(n_prefix_embeds=8)
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, L = self.d_model, self.n_layers
        hd = self.hd
        if self.attn_type == "mla":
            q = (self.q_lora_rank and
                 d * self.q_lora_rank
                 + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                 ) or d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            kv = (d * (self.kv_lora_rank + self.qk_rope_dim)
                  + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim))
            o = self.n_heads * self.v_head_dim * d
            attn = q + kv + o
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        def mlp(ff):
            return (3 if self.mlp_type == "swiglu" else 2) * d * ff
        total = 0
        for i in range(L):
            total += attn
            if self.is_moe and i >= self.moe_dense_prefix:
                total += self.n_experts * mlp(self.d_ff_expert)
                total += self.n_shared_experts * mlp(self.d_ff_expert)
                total += d * self.n_experts  # router
            else:
                total += mlp(self.d_ff)
        if self.is_encoder_decoder:
            total += self.n_encoder_layers * (attn + mlp(self.d_ff)) \
                + L * attn  # cross attention
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE top-k only)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        def mlp(ff):
            return (3 if self.mlp_type == "swiglu" else 2) * d * ff
        moe_layers = L - self.moe_dense_prefix
        inactive = moe_layers * (self.n_experts - self.top_k) * mlp(self.d_ff_expert)
        return full - inactive
