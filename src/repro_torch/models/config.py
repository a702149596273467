"""Model configuration shared by all 10 assigned architectures.

A copy of the JAX package's ``models/config.py``, so the port imports
nothing of it."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention features
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Optional[Tuple[int, ...]] = None  # qwen2-vl M-RoPE (half-dims)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None
    layer_pattern: Tuple[str, ...] = ("global",)  # cycled over layers

    # mlp
    mlp: str = "swiglu"  # swiglu | relu2 | gelu

    # moe
    num_experts: int = 0
    num_experts_padded: int = 0  # >= num_experts; pad for even EP sharding
    top_k: int = 0
    shared_d_ff: int = 0  # total intermediate dim of shared experts (0 = none)
    moe_capacity_factor: float = 1.25  # train-time routed capacity
    first_dense_d_ff: int = 0  # deepseek: layer 0 is a dense MLP of this width

    # ssm (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # hybrid (recurrentgemma)
    lru_width: int = 0

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 0  # precomputed frame embeddings (conv frontend stub)

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    emb_scale_by_sqrt_dim: bool = False  # gemma-style embedding scaling
    dtype: str = "bfloat16"

    # -- derived ---------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def experts_padded(self) -> int:
        return self.num_experts_padded or self.num_experts

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def scaled_down(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers, 2 * len(self.layer_pattern) + (1 if self.first_dense_d_ff else 0)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            local_window=min(self.local_window, 16) if self.local_window else None,
        )
        if self.family == "moe":
            kw.update(num_experts=8, num_experts_padded=8, top_k=min(self.top_k, 2),
                      shared_d_ff=64 if self.shared_d_ff else 0, d_ff=64,
                      first_dense_d_ff=128 if self.first_dense_d_ff else 0,
                      moe_capacity_factor=8.0)
        if self.family == "ssm":
            kw.update(ssm_state=8, ssm_dt_rank=8, d_ff=0, num_heads=1, num_kv_heads=1)
        if self.family == "hybrid":
            kw.update(lru_width=128)
        if self.family == "encdec":
            kw.update(encoder_layers=2, encoder_frames=16)
        if self.mrope_sections:
            kw.update(mrope_sections=(4, 6, 6))
        kw.update(overrides)
        return self.with_(**kw)
