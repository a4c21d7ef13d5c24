"""RecurrentGemma / Griffin hybrid of the port (counterpart of
`repro/models/rglru.py`, arXiv:2402.19427): RG-LRU recurrent blocks and
local-MQA attention blocks interleaved by `cfg.block_pattern`.

Residual block = pre-norm temporal mixer (+residual), then pre-norm SwiGLU
MLP (+residual). Recurrent mixer:
    u = gelu(x W_gate);  z = conv1d_causal(x W_in, width 4);  h = RGLRU(z)
    y = (u * h) W_out
RG-LRU:  r, i = sigm(z W_a + b_a), sigm(z W_x + b_x)
         log a_t = -c * softplus(Lambda) * r_t          (c = 8)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * z_t)

Params: the pattern's blocks stacked over the `n_groups` whole groups
(``layers/p{j}``), then the remainder blocks as a list (``rem``), each with
a leading axis of 1, as in the JAX package.

The recurrence goes through `kernels/rglru_scan`: `decode_step` sends it
(with `impl="auto"`) to the CUDA kernel on the card, at T = 1 from the
block's state; `forward` keeps the JAX package's flag, ``lru_impl="ref"``
(the plain version in `jax.lax.associative_scan`'s order, differentiable)
or ``"kernel"``. The attention blocks decode through the plain
`gqa_attention` over a ring buffer of C = min(cache_len, attn_window)
entries with one shared position map, as the JAX package does.

`decode_step` takes the params of `prepare_params` and updates its cache IN
PLACE; ``cache["pos"]`` is a host int.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models.layers import (attn_out, attn_param_shapes, attn_qkv,
                                       cast_params_for_compute,
                                       chunked_cross_entropy, gelu_tanh,
                                       gqa_attention, init_from_shapes,
                                       layer_slice, residual_mlp, rms_norm,
                                       scan_impl, sigmoid, torch_dtype)

CONV_WIDTH = 4
LRU_C = 8.0

# leaves with a constant init (the JAX package's init_params)
CONSTS = {"conv_b": 0.0, "ba": 0.0, "bx": 0.0, "lam": 0.7, "ln1": 1.0,
          "ln2": 1.0, "final_norm": 1.0}


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _pattern_counts(cfg: ModelConfig):
    P = len(cfg.block_pattern)
    n_groups = cfg.n_layers // P
    rem = tuple(cfg.block_pattern[: cfg.n_layers % P])
    return n_groups, rem


def _block_shapes(cfg: ModelConfig, kind: str, n: int):
    D, F = cfg.d_model, cfg.d_ff
    if kind == "attn":
        mixer = attn_param_shapes(cfg, n)
    else:
        mixer = {"w_gate_br": (n, D, D), "w_in": (n, D, D),
                 "w_out": (n, D, D), "conv_w": (n, CONV_WIDTH, D),
                 "conv_b": (n, D), "wa": (n, D, D), "ba": (n, D),
                 "wx": (n, D, D), "bx": (n, D), "lam": (n, D)}
    return {"mixer": mixer,
            "mlp": {"w_gate": (n, D, F), "w_up": (n, D, F),
                    "w_down": (n, F, D)},
            "ln1": (n, D), "ln2": (n, D)}


def param_shapes(cfg: ModelConfig):
    """The param shapes in the JAX package's layout and tree paths
    (``layers/p0/mixer/wa``, ``rem/0/mlp/w_up`` ...)."""
    n_groups, rem = _pattern_counts(cfg)
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "layers": {f"p{j}": _block_shapes(cfg, kind, n_groups)
                   for j, kind in enumerate(cfg.block_pattern)},
        "rem": [_block_shapes(cfg, kind, 1) for kind in rem],
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random master params in the JAX package's init scheme (embed
    N(0, 0.02), projections and the conv taps N(0, 1/fan_in), `CONSTS`
    elsewhere), drawn from `gen` (a generator on `device`) in
    `param_shapes` order."""
    return init_from_shapes(param_shapes(cfg), gen,
                            torch_dtype(cfg.param_dtype), device, CONSTS)


def prepare_params(cfg: ModelConfig, params, *, release: bool = False):
    """Master params -> the params `decode_step` takes: cast once to the
    compute dtype, the head kept only as ``lm_head_f32`` (the compute-dtype
    head widened to f32). ``release=True`` gives the masters up leaf by
    leaf as it casts."""
    cp = cast_params_for_compute(cfg, params, release=release)
    cp["lm_head_f32"] = cp.pop("lm_head").float()
    return cp


def _blocks(cfg: ModelConfig, tree, rem_tree):
    """(kind, per-block slice of `tree`) for every block in order: the
    groups' pattern blocks, then the remainder blocks."""
    n_groups, rem = _pattern_counts(cfg)
    for g in range(n_groups):
        for j, kind in enumerate(cfg.block_pattern):
            yield kind, layer_slice(tree[f"p{j}"], g)
    for j, kind in enumerate(rem):
        yield kind, layer_slice(rem_tree[j], 0)


# ---------------------------------------------------------------------------
# RG-LRU + conv primitives
# ---------------------------------------------------------------------------


def causal_conv1d(z, w, b, state=None):
    """Depthwise causal conv. z: (B, T, D); w: (W, D); state: (B, W-1, D)
    carry-in. Returns (out (B, T, D), new_state (B, W-1, D)). The taps sum
    from the first, then the bias, as the JAX package's ``sum(...) + b``."""
    B, T, D = z.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, D), dtype=z.dtype, device=z.device)
    zp = torch.cat([state, z], dim=1)                      # (B, T+W-1, D)
    out = zp[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + zp[:, i:i + T] * w[i]
    return (out + b).to(z.dtype), zp[:, -(W - 1):]


def rglru(z, mixer, h0=None, *, impl: str = "ref"):
    """z: (B, T, D) conv output; h0: (B, D) or None. `impl` is the scan
    wrapper's ("ref" or "auto"). Returns (h (B, T, D) in z's dtype,
    h_last (B, D) f32)."""
    zf = z.float()
    r = sigmoid(zf @ mixer["wa"].float() + mixer["ba"])
    i = sigmoid(zf @ mixer["wx"].float() + mixer["bx"])
    lam = mixer["lam"].float()
    log_a = -LRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    b = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) \
        * (i * zf)
    a = torch.exp(log_a)
    h = lru_ops.lru_scan(a, b, h0, impl=impl)
    return h.to(z.dtype), h[:, -1].float()


def rglru_mixer_apply(cfg: ModelConfig, x, mixer, state=None, *,
                      impl: str = "ref"):
    """state: None (train) or {"conv": (B, W-1, D), "h": (B, D)}. Returns
    (y, {"conv", "h"})."""
    u = gelu_tanh(x @ mixer["w_gate_br"])
    z = x @ mixer["w_in"]
    z, conv_state = causal_conv1d(z, mixer["conv_w"], mixer["conv_b"],
                                  None if state is None else state["conv"])
    h, h_last = rglru(z, mixer, None if state is None else state["h"],
                      impl=impl)
    return (u * h) @ mixer["w_out"], {"conv": conv_state, "h": h_last}


# ---------------------------------------------------------------------------
# forward (train / eval)
# ---------------------------------------------------------------------------


def _block_apply(cfg: ModelConfig, x, bp, kind, positions, impl):
    h = rms_norm(x, bp["ln1"], cfg.rms_eps, impl="ref")
    if kind == "attn":
        q, k, v = attn_qkv(h, bp["mixer"], cfg, positions, impl="ref")
        o = gqa_attention(q, k, v, causal=True, window=cfg.attn_window,
                          q_positions=positions, kv_positions=positions)
        x = x + attn_out(o, bp["mixer"], cfg)
    else:
        y, _ = rglru_mixer_apply(cfg, h, bp["mixer"], impl=impl)
        x = x + y
    return residual_mlp(cfg, x, bp, "ref")


def forward(cfg: ModelConfig, params, batch, *, lru_impl: str = "ref"):
    """Master params (the compute cast is differentiable) and a batch
    {tokens (B, S)} -> final hidden states h (B, S, D) in the compute
    dtype. Norms and attention run their plain versions; the scan runs as
    `lru_impl` says."""
    impl = scan_impl(lru_impl)
    cp = cast_params_for_compute(cfg, params)
    tokens = batch["tokens"].long()
    x = cp["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for kind, bp in _blocks(cfg, cp["layers"], cp["rem"]):
        x = _block_apply(cfg, x, bp, kind, positions, impl)
    return rms_norm(x, cp["final_norm"], cfg.rms_eps, impl="ref")


def loss_fn(cfg: ModelConfig, params, batch, *, xent_chunk: int = 512,
            lru_impl: str = "ref"):
    """Mean token NLL of `batch` {tokens, labels}; the head is the f32
    master weight, as in the JAX package. Returns (loss, metrics)."""
    h = forward(cfg, params, batch, lru_impl=lru_impl)
    nll = chunked_cross_entropy(h, params["lm_head"], batch["labels"],
                                chunk=xent_chunk)
    return nll, {"nll": nll, "ppl": torch.exp(nll)}


# ---------------------------------------------------------------------------
# decode — O(1) state (recurrent) + ring-buffer window cache (attention)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None):
    dt = torch_dtype(cfg.compute_dtype)
    D, hd = cfg.d_model, cfg.resolved_head_dim
    C = min(cache_len, cfg.attn_window)   # local attention never needs more
    n_groups, rem = _pattern_counts(cfg)

    def block_cache(kind, n):
        if kind == "attn":
            shape = (n, batch_size, C, cfg.n_kv_heads, hd)
            return {"k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device)}
        return {"conv": torch.zeros((n, batch_size, CONV_WIDTH - 1, D),
                                    dtype=dt, device=device),
                "h": torch.zeros((n, batch_size, D), dtype=torch.float32,
                                 device=device)}

    return {
        "groups": {f"p{j}": block_cache(kind, n_groups)
                   for j, kind in enumerate(cfg.block_pattern)},
        "rem": [block_cache(kind, 1) for kind in rem],
        "kv_pos": torch.full((C,), -1, dtype=torch.int32, device=device),
        "pos": 0,
    }


def _decode_block(cfg: ModelConfig, x, bp, kind, bc, slot, positions,
                  kv_positions, kv_mask, impl):
    """One block at one token; bc: the block's cache slices (views),
    updated in place."""
    h = rms_norm(x, bp["ln1"], cfg.rms_eps, impl=impl)
    if kind == "attn":
        q, k, v = attn_qkv(h, bp["mixer"], cfg, positions, impl=impl)
        bc["k"][:, slot] = k[:, 0]
        bc["v"][:, slot] = v[:, 0]
        o = gqa_attention(q, bc["k"], bc["v"], causal=True,
                          window=cfg.attn_window, q_positions=positions,
                          kv_positions=kv_positions, kv_mask=kv_mask)
        x = x + attn_out(o, bp["mixer"], cfg)
    else:
        y, state = rglru_mixer_apply(cfg, h, bp["mixer"], state=bc,
                                     impl=impl)
        bc["conv"].copy_(state["conv"])
        bc["h"].copy_(state["h"])
        x = x + y
    return residual_mlp(cfg, x, bp, impl)


def decode_step(cfg: ModelConfig, params, cache, tokens, *,
                impl: str = "auto"):
    """One token for every sequence. params: from `prepare_params`; tokens:
    (B,) int. `impl`: "auto" = the kernels (RG-LRU scan, RMSNorm) on CUDA,
    their plain versions on CPU; "ref" = the plain versions. Updates `cache`
    in place and returns (logits (B, V) f32, cache)."""
    B = tokens.shape[0]
    pos = cache["pos"]
    C = cache["kv_pos"].shape[0]
    slot = pos % C
    cache["kv_pos"][slot] = pos
    dev = tokens.device
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    kv_positions = cache["kv_pos"][None].expand(B, C)
    kv_mask = kv_positions >= 0
    x = params["embed"][tokens.long()][:, None, :]
    for (kind, bp), (_, bc) in zip(
            _blocks(cfg, params["layers"], params["rem"]),
            _blocks(cfg, cache["groups"], cache["rem"])):
        x = _decode_block(cfg, x, bp, kind, bc, slot, positions,
                          kv_positions, kv_mask, impl)
    h = rms_norm(x[:, 0], params["final_norm"], cfg.rms_eps, impl=impl)
    cache["pos"] = pos + 1
    return h.float() @ params["lm_head_f32"], cache
