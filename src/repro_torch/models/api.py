"""Model API of the port: dispatch by cfg.family (counterpart of
`repro/models/api.py`). Ported: the dense family (training and slot-plane
serving), the SSM family (RWKV-6) and the hybrid family (RecurrentGemma),
the last two with their lock-step decode (`init_cache`/`decode_step`). The
other families raise until their ROADMAP.md item lands."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import ShapeDtype, tree_map
from repro_torch.models import rglru, rwkv6, transformer
from repro_torch.models.layers import torch_dtype

_FAMILY_MOD = {"dense": transformer, "ssm": rwkv6, "hybrid": rglru}

_TODO = {"moe": transformer.MOE_TODO}


def family_module(cfg: ModelConfig):
    if cfg.family in _FAMILY_MOD and cfg.moe is None:
        return _FAMILY_MOD[cfg.family]
    family = "moe" if cfg.moe is not None else cfg.family
    raise NotImplementedError(_TODO.get(
        family, f"family {family!r} is not ported yet (ROADMAP.md, Queue A: "
                f"'other model families')"))


def init_params(cfg: ModelConfig, gen, device=None):
    return family_module(cfg).init_params(cfg, gen, device)


def param_specs(cfg: ModelConfig):
    """Abstract params (`ShapeDtype` leaves in cfg.param_dtype): the port's
    `jax.eval_shape(init_params)`."""
    dtype = torch_dtype(cfg.param_dtype)
    return tree_map(lambda s: ShapeDtype(tuple(s), dtype),
                    family_module(cfg).param_shapes(cfg))


def forward(cfg: ModelConfig, params, batch, **kw):
    return family_module(cfg).forward(cfg, params, batch, **kw)


def loss_fn(cfg: ModelConfig, params, batch, **kw):
    return family_module(cfg).loss_fn(cfg, params, batch, **kw)


def prepare_params(cfg: ModelConfig, params, **kw):
    return family_module(cfg).prepare_params(cfg, params, **kw)


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None):
    """The lock-step decode cache of the SSM and hybrid families."""
    return family_module(cfg).init_cache(cfg, batch_size, cache_len, device)


def decode_step(cfg: ModelConfig, params, cache, tokens, **kw):
    """One lock-step decode step (SSM and hybrid families)."""
    return family_module(cfg).decode_step(cfg, params, cache, tokens, **kw)


def init_slot_cache(cfg: ModelConfig, n_slots: int, cache_len: int,
                    device=None):
    return family_module(cfg).init_slot_cache(cfg, n_slots, cache_len, device)


def decode_step_slotted(cfg: ModelConfig, params, cache, tokens, **kw):
    return family_module(cfg).decode_step_slotted(cfg, params, cache, tokens,
                                                  **kw)


def prefill_chunk_slotted(cfg: ModelConfig, params, cache, tokens, slot,
                          start, n_valid, **kw):
    return family_module(cfg).prefill_chunk_slotted(cfg, params, cache, tokens,
                                                    slot, start, n_valid, **kw)


def decode_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Effective KV-cache length for a decode shape: ring-buffer bounded by the
    native or long-decode window for windowed archs; full length otherwise."""
    if cfg.family == "ssm":
        return 1  # unused: constant-size state
    win = cfg.attn_window or cfg.long_decode_window
    if cfg.family == "hybrid":
        win = cfg.attn_window
    return min(seq_len, win) if win else seq_len
