"""Decoder-only transformer of the port, dense family: the training and
serving paths of `repro/models/transformer.py` (params, `forward`/`loss_fn`,
slot-plane cache, slotted decode step, chunked slotted prefill).

The training forward runs the plain attention (`gqa_attention`, as the JAX
trainer's ``attn_impl="ref"``) and the plain RMSNorm (``impl="ref"``, the
JAX package's jnp norm): the norm kernel has no backward, and its wrapper
refuses inputs that need a gradient. It keeps every layer's activations
(the JAX package remats the layer scan, a memory choice; paper_150m at
batch 8 x 256 tokens fits without it).

The JAX package scans over stacked layer params under jit; here a Python
loop walks the same stacked tensors eagerly. The serving functions update
the slot-plane cache IN PLACE (the JAX ones return a new cache): the cache is
the largest tensor of the engine, and nothing reads its old value.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models.layers import (attn_out, attn_param_shapes,
                                       attn_qkv, cast_params_for_compute,
                                       chunked_cross_entropy, gqa_attention,
                                       init_from_shapes, layer_slice,
                                       residual_mlp, rms_norm, torch_dtype)

MOE_TODO = ("MoE serving is not ported yet (ROADMAP.md, Queue A: "
            "'MoE serving')")


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.moe is not None or cfg.family != "dense":
        raise NotImplementedError(MOE_TODO if cfg.moe is not None else
                                  f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP.md, Queue A)")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig):
    """Nested dict of the param shapes, in the JAX package's layout and
    tree paths (``layers/attn/wq`` ...)."""
    _check_dense(cfg)
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    shapes = {
        "embed": (V, D),
        "layers": {"attn": attn_param_shapes(cfg, L), "ln1": (L, D),
                   "ln2": (L, D),
                   "mlp": {"w_gate": (L, D, F), "w_up": (L, D, F),
                           "w_down": (L, F, D)}},
        "final_norm": (D,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


# leaves with a constant init: norms 1, biases 0
CONSTS = {"ln1": 1.0, "ln2": 1.0, "final_norm": 1.0, "q_norm": 1.0,
          "k_norm": 1.0, "bq": 0.0, "bk": 0.0, "bv": 0.0, "bo": 0.0}


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random master params in the JAX package's layout and init scheme
    (embed N(0, 0.02); projections N(0, 1/fan_in); norms 1; biases 0),
    drawn from `gen` (a generator on `device`) in `param_shapes` order."""
    return init_from_shapes(param_shapes(cfg), gen,
                            torch_dtype(cfg.param_dtype), device, CONSTS)


def lm_head_weight(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def prepare_params(cfg: ModelConfig, params):
    """Master params -> the params the serving functions take: cast once to
    the compute dtype, plus ``lm_head_f32``, the compute-dtype head widened
    to f32 (the JAX package's ``lm_head.astype(f32)``), held once."""
    _check_dense(cfg)
    cp = cast_params_for_compute(cfg, params)
    cp["lm_head_f32"] = lm_head_weight(cfg, cp).float()
    return cp


def _logits(cfg: ModelConfig, params, x, impl: str):
    h = rms_norm(x, params["final_norm"], cfg.rms_eps, impl=impl)
    return h.float() @ params["lm_head_f32"]


# ---------------------------------------------------------------------------
# forward (train / eval)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, batch):
    """Master params (bf16 compute casts them, differentiably) and a batch
    {tokens (B, S)} -> final hidden states h (B, S, D) in the compute
    dtype."""
    _check_dense(cfg)
    cp = cast_params_for_compute(cfg, params)
    tokens = batch["tokens"].long()
    x = cp["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for l in range(cfg.n_layers):
        lp = layer_slice(cp["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps, impl="ref")
        q, k, v = attn_qkv(h, lp["attn"], cfg, positions, impl="ref")
        o = gqa_attention(q, k, v, causal=True, window=cfg.attn_window,
                          q_positions=positions, kv_positions=positions)
        x = x + attn_out(o, lp["attn"], cfg)
        x = residual_mlp(cfg, x, lp, "ref")
    return rms_norm(x, cp["final_norm"], cfg.rms_eps, impl="ref")


def loss_fn(cfg: ModelConfig, params, batch, *, xent_chunk: int = 512):
    """Mean token NLL of `batch` {tokens, labels}; the head is the f32
    master weight, as in the JAX package. Returns (loss, metrics)."""
    h = forward(cfg, params, batch)
    nll = chunked_cross_entropy(h, lm_head_weight(cfg, params),
                                batch["labels"], chunk=xent_chunk)
    return nll, {"nll": nll, "ppl": torch.exp(nll)}


# ---------------------------------------------------------------------------
# slot-plane serving
# ---------------------------------------------------------------------------


def init_slot_cache(cfg: ModelConfig, n_slots: int, cache_len: int,
                    device=None):
    """Slot-plane KV cache: every slot carries its own ring-buffer position
    map (-1 = empty) and decode position."""
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, n_slots, cache_len, cfg.n_kv_heads, hd)
    dt = torch_dtype(cfg.compute_dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "kv_pos": torch.full((n_slots, cache_len), -1, dtype=torch.int32,
                             device=device),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


def decode_step_slotted(cfg: ModelConfig, params, cache, tokens, *, active,
                        window: Optional[int] = None, impl: str = "auto"):
    """One decode step over the whole slot plane. params: from
    `prepare_params`; tokens: (B,) int (last sampled token per slot); active:
    (B,) bool. Every slot is computed, but only active slots write their
    cache row and advance their position. Updates `cache` in place and
    returns (logits (B, V) f32, cache)."""
    window = window if window is not None else cfg.attn_window
    pos = cache["pos"]                                  # (B,)
    C = cache["k"].shape[2]
    rows = torch.nonzero(active).squeeze(1)             # active slots only
    wcol = (pos[rows] % C).long()
    cache["kv_pos"][rows, wcol] = pos[rows]
    x = params["embed"][tokens][:, None, :]
    positions = pos[:, None]                            # (B, 1)
    for l in range(cfg.n_layers):
        lp = layer_slice(params["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps, impl=impl)
        q, k, v = attn_qkv(h, lp["attn"], cfg, positions, impl=impl)
        kc, vc = cache["k"][l], cache["v"][l]           # (B, C, KV, hd) views
        kc[rows, wcol] = k[rows, 0]
        vc[rows, wcol] = v[rows, 0]
        o = fd_ops.flash_decode(q[:, 0], kc, vc, cache["kv_pos"], pos,
                                window=window, impl=impl)[:, None]
        x = x + attn_out(o, lp["attn"], cfg)
        x = residual_mlp(cfg, x, lp, impl)
    logits = _logits(cfg, params, x[:, 0], impl)
    cache["pos"] += active.to(torch.int32)
    return logits, cache


def prefill_chunk_slotted(cfg: ModelConfig, params, cache, tokens, slot: int,
                          start: int, n_valid: int, *,
                          window: Optional[int] = None, impl: str = "auto"):
    """Prefill one chunk of one slot's prompt into the slot plane. tokens:
    (Pc,) int (entries past n_valid ignored). Writes the chunk's K/V into the
    slot's ring at positions start..start+n_valid-1, sets
    cache['pos'][slot] = start + n_valid (in place), and returns
    (logits (V,) f32 at the chunk's last valid token, cache)."""
    if not 1 <= n_valid <= tokens.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [1, {tokens.shape[0]}]")
    window = window if window is not None else cfg.attn_window
    C = cache["k"].shape[2]
    ar = torch.arange(start, start + n_valid, dtype=torch.int32,
                      device=tokens.device)
    positions = ar[None]                                # (1, n)
    wcol = (ar % C).long()
    kv_row = cache["kv_pos"][slot]                      # (C,) view
    kv_row[wcol] = ar
    kv_mask = (kv_row >= 0)[None]
    x = params["embed"][tokens[:n_valid]][None]
    for l in range(cfg.n_layers):
        lp = layer_slice(params["layers"], l)
        h = rms_norm(x, lp["ln1"], cfg.rms_eps, impl=impl)
        q, k, v = attn_qkv(h, lp["attn"], cfg, positions, impl=impl)
        kc, vc = cache["k"][l, slot], cache["v"][l, slot]   # (C, KV, hd)
        kc[wcol] = k[0]
        vc[wcol] = v[0]
        # chunk queries attend over the updated row: earlier cache content
        # plus the in-chunk prefix, both selected by position (kp <= qp)
        o = gqa_attention(q, kc[None], vc[None], causal=True, window=window,
                          q_positions=positions, kv_positions=kv_row[None],
                          kv_mask=kv_mask)
        x = x + attn_out(o, lp["attn"], cfg)
        x = residual_mlp(cfg, x, lp, impl)
    logits = _logits(cfg, params, x[0, n_valid - 1], impl)
    cache["pos"][slot] = start + n_valid
    return logits, cache
