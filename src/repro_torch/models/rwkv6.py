"""RWKV-6 "Finch" of the port, the SSM family (counterpart of
`repro/models/rwkv6.py`, arXiv:2404.05892): params, `forward`/`loss_fn`, and
the O(1)-state decode the lock-step server runs.

Per layer: time-mix block (data-dependent token-shift ddlerp + data-dependent
decay WKV recurrence with an hd x hd state per head) and channel-mix block
(squared-ReLU MLP with receptance gate); the LayerNorms are RMSNorms, as in
the JAX package.

The WKV recurrence goes through `kernels/rwkv6_scan`: `decode_step` sends
it (with `impl="auto"`) to the CUDA kernel on the card, at T = 1 from the
layer's state; `forward` keeps the JAX package's flag, ``wkv_impl="ref"``
(the plain, differentiable version: training runs on it) or ``"kernel"``.
The JAX decode computes the same function through its jnp reference.

`decode_step` takes the params of `prepare_params` (cast once to the compute
dtype, plus the f32 head) and updates its cache IN PLACE (the JAX one
returns a new cache); ``cache["pos"]`` is a host int.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models.layers import (cast_params_for_compute,
                                       chunked_cross_entropy,
                                       init_from_shapes, layer_slice,
                                       rms_norm, scan_impl, sigmoid, silu,
                                       torch_dtype)

LORA_RANK = 32

# leaves with a constant init (the JAX package's init_params)
CONSTS = {"mu_x": 0.0, "mu": 0.0, "lora_b": 0.0, "w0": -6.0, "wb": 0.0,
          "u": 0.0, "gn": 1.0, "mu_k": 0.0, "mu_r": 0.0, "ln1": 1.0,
          "ln2": 1.0, "final_norm": 1.0}


def _lora_rank(cfg: ModelConfig) -> int:
    return min(LORA_RANK, max(4, cfg.d_model // 16))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig):
    """Nested dict of the param shapes, in the JAX package's layout and tree
    paths (``layers/tm/wr`` ...)."""
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    r = _lora_rank(cfg)
    tm = {"mu_x": (L, D), "mu": (L, 5, D), "lora_a": (L, 5, D, r),
          "lora_b": (L, 5, r, D), "w0": (L, D), "wa": (L, D, r),
          "wb": (L, r, D), "u": (L, D), "wr": (L, D, D), "wk": (L, D, D),
          "wv": (L, D, D), "wg": (L, D, D), "wo": (L, D, D), "gn": (L, D)}
    cm = {"mu_k": (L, D), "mu_r": (L, D), "wk": (L, D, F), "wv": (L, F, D),
          "wr": (L, D, D)}
    return {"embed": (V, D),
            "layers": {"tm": tm, "cm": cm, "ln1": (L, D), "ln2": (L, D)},
            "final_norm": (D,), "lm_head": (D, V)}


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random master params in the JAX package's init scheme (embed
    N(0, 0.02), projections N(0, 1/fan_in), `CONSTS` elsewhere), drawn from
    `gen` (a generator on `device`) in `param_shapes` order."""
    return init_from_shapes(param_shapes(cfg), gen,
                            torch_dtype(cfg.param_dtype), device, CONSTS)


def prepare_params(cfg: ModelConfig, params, *, release: bool = False):
    """Master params -> the params `decode_step` takes: cast once to the
    compute dtype, the head kept only as ``lm_head_f32`` (the compute-dtype
    head widened to f32: the JAX decode's ``lm_head.astype(f32)``).
    ``release=True`` gives the masters up leaf by leaf as it casts."""
    cp = cast_params_for_compute(cfg, params, release=release)
    cp["lm_head_f32"] = cp.pop("lm_head").float()
    return cp


# ---------------------------------------------------------------------------
# time mix / channel mix
# ---------------------------------------------------------------------------


def _group_norm(o, scale, eps):
    """o: (B, T, H, hd): normalise per head, f32 statistics."""
    of = o.float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, correction=0)
    of = (of - mu) * torch.rsqrt(var + eps)
    B, T, H, hd = o.shape
    return (of.reshape(B, T, H * hd) * scale.float()).to(o.dtype)


def _ddlerp(x, x_prev, tm):
    """Finch data-dependent token shift. x, x_prev: (B, T, D). Returns the 5
    mixed streams (r, w, k, v, g), each (B, T, D)."""
    dx = x_prev - x
    xx = x + dx * tm["mu_x"]
    z = torch.tanh(torch.einsum("btd,ndr->btnr", xx, tm["lora_a"]))
    dyn = torch.einsum("btnr,nrd->btnd", z, tm["lora_b"])
    mix = tm["mu"][None, None] + dyn                            # (B,T,5,D)
    return tuple(x + dx * mix[:, :, j] for j in range(5))


def time_mix(cfg: ModelConfig, x, x_prev, tm, s0=None, *,
             impl: str = "ref"):
    """x: (B, T, D); x_prev: x shifted right by one (first slot = carry-in);
    s0: (B, H, hd, hd) f32 or None. `impl` is the scan wrapper's ("ref" or
    "auto"). Returns (y (B, T, D), sT (B, H, hd, hd) f32)."""
    B, T, D = x.shape
    H, hd = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    xr, xw, xk, xv, xg = _ddlerp(x, x_prev, tm)
    r = (xr @ tm["wr"]).reshape(B, T, H, hd)
    kk = (xk @ tm["wk"]).reshape(B, T, H, hd)
    vv = (xv @ tm["wv"]).reshape(B, T, H, hd)
    g = xg @ tm["wg"]
    logw = tm["w0"][None, None] + (torch.tanh(xw) @ tm["wa"]) @ tm["wb"]
    # the decay in the compute dtype, as the JAX package hands it to the scan
    w = torch.exp(-torch.exp(logw.float())).reshape(B, T, H, hd).to(r.dtype)
    u = tm["u"].reshape(H, hd).float()
    o, sT = wkv_ops.wkv_scan(r, kk, vv, w, u, s0, impl=impl)
    o = _group_norm(o, tm["gn"], cfg.rms_eps)
    return (o * silu(g)) @ tm["wo"], sT


def channel_mix(x, x_prev, cm):
    dx = x_prev - x
    xk = x + dx * cm["mu_k"]
    xr = x + dx * cm["mu_r"]
    k = torch.square(torch.relu(xk @ cm["wk"]))
    return sigmoid(xr @ cm["wr"]) * (k @ cm["wv"])


def _shift(x, carry_in=None):
    """Token shift: y[:, t] = x[:, t-1]; y[:, 0] = carry_in (or 0)."""
    first = (torch.zeros_like(x[:, :1]) if carry_in is None
             else carry_in[:, None])
    return torch.cat([first, x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# forward (train / eval)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, batch, *, wkv_impl: str = "ref"):
    """Master params (the compute cast is differentiable) and a batch
    {tokens (B, S)} -> final hidden states h (B, S, D) in the compute
    dtype. Norms run their plain version (no backward kernel); the scan
    runs as `wkv_impl` says."""
    impl = scan_impl(wkv_impl)
    cp = cast_params_for_compute(cfg, params)
    x = cp["embed"][batch["tokens"].long()]
    for l in range(cfg.n_layers):
        lp = layer_slice(cp["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps, impl="ref")
        y, _ = time_mix(cfg, h, _shift(h), lp["tm"], impl=impl)
        x = x + y
        h = rms_norm(x, lp["ln2"], cfg.rms_eps, impl="ref")
        x = x + channel_mix(h, _shift(h), lp["cm"])
    return rms_norm(x, cp["final_norm"], cfg.rms_eps, impl="ref")


def loss_fn(cfg: ModelConfig, params, batch, *, xent_chunk: int = 512,
            wkv_impl: str = "ref"):
    """Mean token NLL of `batch` {tokens, labels}; the head is the f32
    master weight, as in the JAX package. Returns (loss, metrics)."""
    h = forward(cfg, params, batch, wkv_impl=wkv_impl)
    nll = chunked_cross_entropy(h, params["lm_head"], batch["labels"],
                                chunk=xent_chunk)
    return nll, {"nll": nll, "ppl": torch.exp(nll)}


# ---------------------------------------------------------------------------
# decode — O(1) state per token
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None):
    """cache_len is irrelevant for an SSM (constant-size state); kept for
    API parity."""
    D, L = cfg.d_model, cfg.n_layers
    H, hd = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    dt = torch_dtype(cfg.compute_dtype)
    return {
        "x_prev_tm": torch.zeros((L, batch_size, D), dtype=dt, device=device),
        "x_prev_cm": torch.zeros((L, batch_size, D), dtype=dt, device=device),
        "s": torch.zeros((L, batch_size, H, hd, hd), dtype=torch.float32,
                         device=device),
        "pos": 0,
    }


def decode_step(cfg: ModelConfig, params, cache, tokens, *,
                impl: str = "auto"):
    """One token for every sequence. params: from `prepare_params`; tokens:
    (B,) int. `impl`: "auto" = the kernels (WKV scan, RMSNorm) on CUDA,
    their plain versions on CPU; "ref" = the plain versions. Updates `cache`
    in place and returns (logits (B, V) f32, cache)."""
    x = params["embed"][tokens.long()][:, None, :]
    for l in range(cfg.n_layers):
        lp = layer_slice(params["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps, impl=impl)
        y, sT = time_mix(cfg, h, cache["x_prev_tm"][l][:, None, :],
                         lp["tm"], s0=cache["s"][l], impl=impl)
        cache["x_prev_tm"][l] = h[:, 0]
        cache["s"][l] = sT
        x = x + y
        h = rms_norm(x, lp["ln2"], cfg.rms_eps, impl=impl)
        x = x + channel_mix(h, cache["x_prev_cm"][l][:, None, :], lp["cm"])
        cache["x_prev_cm"][l] = h[:, 0]
    h = rms_norm(x[:, 0], params["final_norm"], cfg.rms_eps, impl=impl)
    cache["pos"] += 1
    return h.float() @ params["lm_head_f32"], cache
