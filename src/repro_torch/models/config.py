"""Unified architecture config for every assigned model family."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DSAConfig:
    """DeepSeek Sparse Attention decode config (the paper's setting)."""
    enabled: bool = True
    k: int = 2048                   # Top-K selection size
    indexer_heads: int = 64         # H in Eq. 1
    indexer_dim: int = 128          # d_i
    min_n: int = 4096               # dense decode below this cache length
    selector: str = "auto"          # auto | gvr | radix | exact | sp_gvr
    max_candidates: int = 6144      # C (MAX_CANDIDATES)
    gate_max_n: int = 200_000       # paper's canUseHeuristic N bound


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_kind: str = "rope"         # rope | rope2d | mrope
    rope_base: float = 10000.0
    rope_fraction: float = 1.0      # chatglm applies RoPE to half the dims
    swa_window: Optional[int] = None
    moe: MoEConfig = MoEConfig()
    dsa: DSAConfig = DSAConfig()
    # hybrid (jamba): one attention layer every `attn_every` layers
    attn_every: int = 0             # 0 = all-attention
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # rwkv6
    rwkv_head_dim: int = 64
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500      # stubbed conv frontend output length
    # vlm (qwen2-vl)
    num_patches: int = 0            # stubbed patch embedding prefix length
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe.num_experts:
            ff = self.moe.num_experts * 3 * d * self.moe.expert_d_ff + d * self.moe.num_experts
        else:
            ff = 3 * d * f
        if self.family == "ssm":
            di = d * self.mamba_expand
            blocks = l * (2 * d * di + di * d + 2 * d * f)   # rough rwkv blocks
        elif self.attn_every:
            # hybrid (jamba): MoE on odd layers, dense FFN on even (1:1 split)
            n_attn = l // self.attn_every
            n_mamba = l - n_attn
            di = d * self.mamba_expand
            dtr = max(d // 16, 1)
            mamba = (2 * d * di + di * (dtr + 2 * self.mamba_d_state)
                     + dtr * di + di * d)
            moe_ff = self.moe.num_experts * 3 * d * self.moe.expert_d_ff
            dense_ff = 3 * d * f
            blocks = (n_attn * attn + n_mamba * mamba
                      + (l // 2) * moe_ff + (l // 2) * dense_ff)
        else:
            blocks = l * (attn + ff)
        if self.dsa.enabled and not self.is_attention_free:
            blocks += l * (d * self.dsa.indexer_heads * self.dsa.indexer_dim
                           + d * self.dsa.indexer_dim)
        if self.encoder_layers:
            blocks += self.encoder_layers * (attn + ff) + l * attn  # cross-attn
        return emb + blocks

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k instead of all experts)."""
        if not self.moe.num_experts:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        n_moe = l // 2 if self.attn_every else l   # hybrid: MoE every 2nd layer
        full = self.param_count()
        all_ff = n_moe * self.moe.num_experts * 3 * d * self.moe.expert_d_ff
        act_ff = n_moe * self.moe.top_k * 3 * d * self.moe.expert_d_ff
        return full - all_ff + act_ff
