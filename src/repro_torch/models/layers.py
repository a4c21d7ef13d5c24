"""Common model primitives of the port (counterpart of `repro/models/layers.py`):
RMSNorm, RoPE, SwiGLU, the activations as XLA evaluates them, GQA
attention, q/k/v projections, init helpers, chunked cross-entropy.

Params are plain dicts of tensors in the JAX package's layout: layer params
stacked along a leading layer axis, projections stored as ``x @ W``. The
hybrid's tree also holds a list (its remainder blocks, ``rem``).
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


def init_from_shapes(shapes, gen: torch.Generator, dtype, device,
                     consts: dict):
    """Random params for a tree of shapes (dicts and lists), drawn from
    `gen` in the tree's order: a leaf named in `consts` is filled with that
    value, ``embed`` takes `embed_init`, every other leaf `dense_init`."""
    def init(name, shape):
        if isinstance(shape, dict):
            return {k: init(k, v) for k, v in shape.items()}
        if isinstance(shape, list):
            return [init(name, v) for v in shape]
        if name in consts:
            return torch.full(shape, consts[name], dtype=dtype, device=device)
        if name == "embed":
            return embed_init(gen, shape, dtype, device)
        return dense_init(gen, shape, dtype, device)

    return init("", shapes)


# ---------------------------------------------------------------------------
# norms / rope / mlp
# ---------------------------------------------------------------------------


def cast_params_for_compute(cfg: ModelConfig, params, *,
                            release: bool = False):
    """AMP policy (bf16 compute over f32 masters): a copy of the float params
    in the compute dtype. The JAX package casts on every forward call; the
    port casts once, when the serving engine is built. ``release=True``
    empties `params` leaf by leaf as it casts (the caller gives the masters
    up), so the masters and their copy never coexist whole: serving
    recurrentgemma-9b would otherwise hold 41.8 + 20.9 GB at once."""
    compute = torch_dtype(cfg.compute_dtype)

    def cast(node):
        if isinstance(node, (dict, list)):
            keys = list(node) if isinstance(node, dict) else range(len(node))
            out = {} if isinstance(node, dict) else [None] * len(node)
            for k in keys:
                out[k] = cast(node[k])
                if release:
                    node[k] = None
            return out
        return node.to(compute) if node.is_floating_point() else node

    return cast(params)


def rms_norm(x, weight, eps=1e-5, *, impl: str = "auto"):
    """f32-statistics RMSNorm; the Triton kernel for CUDA tensors."""
    return rms_ops.rms_norm(x, weight, eps, impl=impl)


def layer_slice(tree, i: int):
    """The i-th slice along the leading (layer) axis of every leaf of a
    dict tree of stacked params or caches (views, no copy)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def scan_impl(flag: str) -> str:
    """A forward's ``wkv_impl``/``lru_impl`` flag (the JAX package's "ref"
    or "kernel") -> the scan wrapper's impl ("ref" or "auto")."""
    impls = {"ref": "ref", "kernel": "auto"}
    if flag not in impls:
        raise ValueError(f"unknown scan impl {flag!r}; options: ref|kernel")
    return impls[flag]


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


def sigmoid(x):
    """`jax.nn.sigmoid` as XLA evaluates it: 1/(1+exp(-x)), each op rounded
    to x's dtype (torch.sigmoid rounds once and differs in ~30% of bf16
    elements)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


def gelu_tanh(x):
    """`jax.nn.gelu` (approximate=True, its default): the tanh form,
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), op by op in x's
    dtype with the constants rounded to it, as JAX writes it."""
    c = _rounded(math.sqrt(2 / math.pi), x.dtype)
    a = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1 + torch.tanh(c * (x + a * (x * (x * x))))))


def _rounded(value: float, dtype) -> float:
    """`value` rounded to `dtype`, as a host float (no device copy)."""
    return torch.tensor(value, dtype=dtype).item()


def swiglu(x, w_gate, w_up, w_down):
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


def residual_mlp(cfg: ModelConfig, x, lp, impl: str):
    """x + SwiGLU(RMSNorm(x)) with a layer's ``ln2`` and ``mlp`` params."""
    h = rms_norm(x, lp["ln2"], cfg.rms_eps, impl=impl)
    mlp = lp["mlp"]
    return x + swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"])


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


def attn_param_shapes(cfg: ModelConfig, n: int):
    """Shapes of `n` stacked attention layers' projections (and qk-norm
    scales and biases where the config has them)."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    attn = {"wq": (n, D, H * hd), "wk": (n, D, KV * hd),
            "wv": (n, D, KV * hd), "wo": (n, H * hd, D)}
    if cfg.qk_norm:
        attn.update(q_norm=(n, hd), k_norm=(n, hd))
    if cfg.attn_bias:
        attn.update(bq=(n, H * hd), bk=(n, KV * hd), bv=(n, KV * hd),
                    bo=(n, D))
    return attn


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
