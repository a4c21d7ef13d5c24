"""Model config dataclasses for the PyTorch port: a copy of the JAX package's
``ModelConfig``/``MoEConfig`` (`repro/configs/base.py`), kept here so the port
imports nothing of the JAX package. No torch import at module scope.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor only matters for dropping implementations; the dense-dispatch
    # einsum path used here never drops tokens.
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config.

    family:
      dense   — decoder-only transformer (GQA + RoPE + SwiGLU)
      moe     — dense skeleton with MoE FFN every layer
      ssm     — RWKV-6 (attention free)
      hybrid  — RecurrentGemma (RG-LRU + local attention, pattern)
      vlm     — dense decoder consuming projected patch embeddings (frontend stubbed)
      audio   — encoder-decoder; encoder consumes frame embeddings (frontend stubbed)
    """
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # sliding-window attention; None = full causal. For hybrid archs this is the
    # local-attention window.
    attn_window: Optional[int] = None
    # window used ONLY for the long_500k decode variant of natively-full-attention
    # archs (the allowed block-sparse/sliding carve-out, DESIGN.md §4). None = the
    # arch has no long-decode variant (either native window/SSM covers it, or skip).
    long_decode_window: Optional[int] = None
    # hybrid pattern, e.g. ("rglru","rglru","attn") repeated; only for family=hybrid
    block_pattern: Tuple[str, ...] = ()
    # encoder layers (family=audio enc-dec); n_layers is then the decoder depth
    n_enc_layers: int = 0
    # rwkv6
    rwkv_head_dim: int = 64
    # vlm / audio stub frontends: number of prefix embedding tokens & their dim
    n_prefix_tokens: int = 0
    prefix_dim: int = 0
    # citation for the config (model card / paper)
    source: str = ""
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """sub-quadratic decode path: SSM/hybrid natively; dense/moe/vlm only when a
        sliding window is configured (block-sparse carve-out, see DESIGN.md)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.family == "audio":
            return False  # enc-dec full-attention decoder: skip long_500k (DESIGN.md)
        return self.attn_window is not None or self.long_decode_window is not None

    def reduced(self) -> "ModelConfig":
        """Reduced smoke-test variant of the same family (<=2 layers, d_model<=512,
        <=4 experts) per the deliverable-(f) spec."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, 2))
        moe = None
        if self.moe is not None:
            moe = MoEConfig(num_experts=min(self.moe.num_experts, 4),
                            top_k=min(self.moe.top_k, 2))
        pattern = self.block_pattern[:3] if self.block_pattern else ()
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 if not pattern else len(pattern),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            moe=moe,
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            long_decode_window=min(self.long_decode_window, 64)
            if self.long_decode_window else None,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_prefix_tokens=min(self.n_prefix_tokens, 8) if self.n_prefix_tokens else 0,
            prefix_dim=min(self.prefix_dim, 64) if self.prefix_dim else 0,
            rwkv_head_dim=min(self.rwkv_head_dim, 32),
        )
