"""Common model primitives of the port (counterpart of `repro/models/layers.py`):
RMSNorm, RoPE, SwiGLU, GQA attention, q/k/v projections, init helpers,
chunked cross-entropy.

Params are plain dicts of tensors in the JAX package's layout: layer params
stacked along a leading layer axis, projections stored as ``x @ W``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rms_norm import ops as rms_ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, device):
    """N(0, 1/fan_in) for an ``x @ W`` weight; fan_in = shape[-2]."""
    std = 1.0 / math.sqrt(shape[-2])
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope / mlp
# ---------------------------------------------------------------------------


def cast_params_for_compute(cfg: ModelConfig, params):
    """AMP policy (bf16 compute over f32 masters): a copy of the float params
    in the compute dtype. The JAX package casts on every forward call; the
    port casts once, when the serving engine is built."""
    compute = torch_dtype(cfg.compute_dtype)

    def cast(a):
        if isinstance(a, dict):
            return {k: cast(v) for k, v in a.items()}
        return a.to(compute) if a.is_floating_point() else a

    return cast(params)


def rms_norm(x, weight, eps=1e-5, *, impl: str = "auto"):
    """f32-statistics RMSNorm; the Triton kernel for CUDA tensors."""
    return rms_ops.rms_norm(x, weight, eps, impl=impl)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int. Split-halves rotation with
    f32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                         # (hd/2,)
    angles = positions[..., :, None].float()[..., None, :] * freqs  # (...,S,1,hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    # silu as XLA evaluates jax.nn.silu: g * 1/(1+exp(-g)), each op rounded
    # to the compute dtype (torch.sigmoid rounds once and differs in ~30% of
    # bf16 elements)
    g = x @ w_gate
    return (g * (1 / (1 + torch.exp(-g))) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def gqa_attention(q, k, v, *, causal: bool, window: Optional[int],
                  q_positions=None, kv_positions=None, kv_mask=None):
    """Plain GQA attention (the JAX package's reference attention).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). H % KV == 0.
    kv_mask: (B, Sk) bool validity mask. Masked logits are filled with -1e30,
    so a row with no valid key gets the mean of V, as in the JAX package.
    Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    qh = q.reshape(B, Sq, KV, group, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float()) * scale
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(Sk, device=q.device)[None, :]
    qp = q_positions[:, None, None, :, None]
    kp = kv_positions[:, None, None, None, :]
    mask = torch.ones((B, 1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, None, :]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attn_qkv(x, lp, cfg: ModelConfig, positions, *, impl: str = "auto"):
    """Project to q/k/v for one layer (lp = per-layer slice of the stacked
    params), with qk-norm, bias and RoPE as the config says."""
    hd = cfg.resolved_head_dim
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.unflatten(-1, (cfg.n_heads, hd))
    k = k.unflatten(-1, (cfg.n_kv_heads, hd))
    v = v.unflatten(-1, (cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps, impl=impl)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps, impl=impl)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(o, lp, cfg: ModelConfig):
    y = o.flatten(-2) @ lp["wo"]
    if cfg.attn_bias:
        y = y + lp["bo"]
    return y


# ---------------------------------------------------------------------------
# chunked cross-entropy (never materializes the full (B,S,V) logits)
# ---------------------------------------------------------------------------


def chunked_cross_entropy(h, lm_head, labels, *, chunk: int = 512):
    """h: (B, S, D) final hidden states; lm_head: (D, V); labels: (B, S).

    Mean token NLL over sequence chunks of `chunk` (then the remainder), as
    the JAX package's scan does: f32 logits ``h.float() @ lm_head.float()``
    for one chunk at a time, so peak memory is O(B * chunk * V)."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    w = lm_head.float()

    def chunk_nll(hc, lc):
        logits = hc.float() @ w
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return lse - gold                                         # (B, c)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + chunk_nll(h[:, sl], labels[:, sl]).sum()
    if S - n * chunk:
        total = total + chunk_nll(h[:, n * chunk:], labels[:, n * chunk:]).sum()
    return total / (B * S)
