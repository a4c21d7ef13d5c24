"""Config dataclasses for the PyTorch port: copies of the JAX package's
``ModelConfig``/``MoEConfig``/``CoCoDCConfig`` (`repro/configs/base.py`),
kept here so the port imports nothing of the JAX package. No torch import at
module scope.
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


@dataclass(frozen=True)
class CoCoDCConfig:
    """Protocol hyperparameters (paper §IV defaults)."""
    num_workers: int = 4           # M
    local_steps: int = 100         # H
    num_fragments: int = 4         # K
    overlap_depth: int = 5         # tau
    mixing_alpha: float = 0.5      # Streaming DiLoCo blending (Eq. 3)
    comp_lambda: float = 0.5       # delay compensation strength (Eq. 7)
    net_utilization: float = 0.4   # gamma (Eq. 9)
    eq4_sign: float = 1.0          # +1 = self-consistent form; -1 = literal Eq. (4)
    outer_lr: float = 0.7
    outer_momentum: float = 0.9    # Nesterov (DiLoCo defaults)
    strided_fragments: bool = True # Streaming DiLoCo strided layer->fragment pattern
    # fragmentation strategy override: "" derives from strided_fragments
    # ("strided"/"contiguous"); "skewed" builds size-skewed fragments
    # (geometric byte shares) so per-fragment WAN costs differ enough for
    # Algorithm-2 link pricing to flip selections
    fragment_strategy: str = ""
    # WAN payload dtype for the pseudo-gradient all-reduce. bf16 halves the
    # cross-region bytes (beyond-paper optimization, §Perf iteration 4);
    # outer-optimizer accumulation stays f32 either way.
    sync_dtype: str = "float32"
    # top-k magnitude sparsification of pseudo-gradients before the WAN
    # all-reduce (beyond-paper): 1.0 = dense. Accounted bytes scale by
    # 2*frac (values + indices).
    sync_topk_frac: float = 1.0
    # Algorithm-2 link-aware pricing (beyond-paper): rank fragments by
    # change-rate per WAN-second (R_p / T_s,p) instead of raw R_p, so cheaper
    # fragments win ties on heterogeneous topologies. Off = literal Eq. 12.
    link_pricing: bool = False
    # Routed communication plans (beyond-paper): "static" keeps the fixed
    # ring/hierarchical cost formulas; "routed" plans every collective over the CURRENT link state — deterministic multi-hop
    # min-cost routes, re-planned at each LinkDynamics edge — and refreshes
    # the Algorithm-2 cost vector from the active plan.
    routing: str = "static"
    # With routing="routed": while the declared hub's links are out,
    # deterministically re-elect the next-best-connected region as hub
    # (restored on recovery) and drop fully dark regions from the collective
    # instead of stalling it.
    hub_failover: bool = False
    # Re-derive Eq. 9's target sync count N (and Eq. 10's h) once per outer
    # round from the MEASURED durations of recent transfers, so the cocodc
    # initiation cadence tracks the network the run actually sees.
    adaptive_resync: bool = False
    # Wire-compression codec for the pseudo-gradient payload (beyond-paper,
    # Streaming-DiLoCo-style compressed outer deltas): "none" keeps the
    # f32/sync_dtype wire format bitwise; "int8"/"int4" quantize each delta
    # per `codec_block`-element block (absmax scaling, kernels/delta_codec)
    # before it crosses the WAN. The codec subsumes sync_dtype accounting —
    # whatever dtype the payload was in, the wire carries codes + scales.
    wire_codec: str = "none"
    # quantization granularity: one f32 absmax scale ships per `codec_block`
    # consecutive elements of each leaf (wire overhead 4/codec_block B/elem)
    codec_block: int = 256
    # error feedback: keep the per-element quantization residual locally and
    # fold it into the same elements' next initiation, driving the cumulative
    # quantization bias to ~0 over repeated syncs (EF-SGD)
    codec_error_feedback: bool = True
    # WAN channel scheduler (beyond-paper traffic plane). "serial" keeps the
    # fixed `concurrent_collectives` channel queue;
    # "fairshare" drops the queue entirely: every in-flight collective shares
    # link capacity via max-min water-filling (core/network.FairShareSim), so
    # a transfer's completion depends on who shares its bottleneck links and
    # Eq. 9's measured durations include real contention.
    channel_scheduler: str = "serial"
    # With routing="routed": split every logical link's payload across up to
    # k edge-disjoint min-cost paths (inverse-cost byte shares; completion =
    # slowest subflow). 1 = single-path (bitwise-pinned arithmetic).
    multipath_k: int = 1
    # Fused outer-update plane: route every protocol transition through the
    # flat fragment plane (core/flatplane.py) + kernels/outer_update — one
    # kernel launch per fragment per stage instead of one per leaf per
    # stage, and flat (rows, LANES) in-flight/residual buffers instead of
    # full-model trees. Off keeps the per-leaf path. Flat-plane semantics:
    # top-k sparsification and codec blocks span the fragment's concatenated
    # leaves rather than respecting leaf boundaries.
    fused_updates: bool = False
