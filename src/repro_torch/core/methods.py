"""Pluggable sync-method strategy registry (the DiLoCo family), the port's
counterpart of `repro/core/methods.py`: `diloco`, `streaming`, `cocodc` and
`local`, each one registered `SyncMethod` with the same event hooks.

  host side:   `next_event_step(eng, t)`, `on_step_end(eng, t, params)`
  device side: `apply_delivery(...)` (per-leaf engine) and
               `fused_delivery` + `fused_delivery_kwargs` (fused engine)

The overlap depth tau = max(1, t - t_init) of a CoCoDC delivery is computed
on the device from the engine's (K,) t_init tensor, so a delivery never
reads a device value back to the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import adaptive as adaptive_lib
from repro_torch.core import delay_comp as dc_lib

_REGISTRY: Dict[str, "SyncMethod"] = {}


def register_method(cls: type) -> type:
    """Class decorator: instantiate `cls` and register it under its name
    (latest wins)."""
    inst = cls()
    if not getattr(inst, "name", ""):
        raise ValueError(f"{cls.__name__} must define a non-empty `name`")
    _REGISTRY[inst.name] = inst
    return cls


def registered_methods() -> Tuple[str, ...]:
    """Sorted names of every registered sync method."""
    return tuple(sorted(_REGISTRY))


def get_method(name: str) -> "SyncMethod":
    """Registry lookup; unknown names raise listing what IS registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown sync method {name!r}; registered methods: "
            f"{', '.join(registered_methods())}") from None


def overlap_depth(t: int, t_init: torch.Tensor) -> torch.Tensor:
    """max(1, t - t_init) as a 0-d f32 tensor on t_init's device."""
    return torch.clamp(t - t_init, min=1).to(torch.float32)


class SyncMethod:
    """Base strategy: local-SGD semantics (no cross-region traffic)."""

    name: str = ""
    overlapped: bool = False
    keeps_snapshot: bool = False
    supports_adaptive_resync: bool = False
    # kernels/outer_update deliver mode under `fused_updates`
    fused_delivery: str = ""

    def next_event_step(self, eng, t: int) -> Optional[int]:
        """Smallest step t' >= t with a protocol action; None = never."""
        return None

    def on_step_end(self, eng, t: int, params_stack):
        """Protocol action after inner step t. Returns the params stack."""
        return params_stack

    def apply_delivery(self, ccfg, dc_impl, *, local_now, snapshot, g_b,
                       t, t_init):
        raise NotImplementedError(
            f"method {self.name!r} parks no fragments in flight")

    def fused_delivery_kwargs(self, ccfg, *, t, t_init) -> dict:
        return {}


@register_method
class LocalSGD(SyncMethod):
    """No synchronization at all — the isolated-datacenter baseline."""
    name = "local"


@register_method
class DiLoCo(SyncMethod):
    """Blocking DiLoCo: full-model all-reduce + outer update every H steps;
    all workers restart from the new consensus (wall-clock pays the WAN)."""
    name = "diloco"

    def next_event_step(self, eng, t: int) -> int:
        return t + (eng.H - 1 - t) % eng.H

    def on_step_end(self, eng, t: int, params_stack):
        if (t + 1) % eng.H == 0:
            finish, _ = eng._schedule_transfer(eng.frag.total_bytes)
            eng.wall_clock = max(eng.wall_clock, finish)   # BLOCKING
            eng.state, params_stack = eng._fns.diloco_round(
                eng.state, params_stack)
        return params_stack


class OverlappedMethod(SyncMethod):
    """Methods that overlap fragment all-reduces with computation: due
    deliveries first, then the method's own initiation rule."""
    overlapped = True

    def sync_interval(self, eng) -> int:
        raise NotImplementedError

    def extra_event_step(self, eng, t: int) -> Optional[int]:
        return None

    def initiate_due(self, eng, t: int, params_stack) -> None:
        raise NotImplementedError

    def after_deliveries(self, eng, t: int) -> None:
        pass

    def next_event_step(self, eng, t: int) -> int:
        h = self.sync_interval(eng)
        nxt = t if t % h == 0 else t + h - t % h
        extra = self.extra_event_step(eng, t)
        if extra is not None:
            nxt = min(nxt, extra)
        for ev in eng.pending:
            nxt = min(nxt, max(t, ev.deliver_at))
        return nxt

    def on_step_end(self, eng, t: int, params_stack):
        params_stack = eng._process_deliveries(t, params_stack)
        self.initiate_due(eng, t, params_stack)
        self.after_deliveries(eng, t)
        return params_stack


@register_method
class StreamingDiLoCo(OverlappedMethod):
    """Streaming DiLoCo: fixed round-robin fragment schedule (one fragment
    every H/K steps), Eq. 3 blending on delivery."""
    name = "streaming"
    fused_delivery = "blend"

    def sync_interval(self, eng) -> int:
        return eng.h_stream

    def initiate_due(self, eng, t: int, params_stack) -> None:
        if t % eng.h_stream == 0:
            p = (t // eng.h_stream) % eng.K
            if all(ev.frag != p for ev in eng.pending):
                eng._initiate(t, params_stack, p)

    def apply_delivery(self, ccfg, dc_impl, *, local_now, snapshot, g_b,
                       t, t_init):
        return dc_lib.blend(local_now, g_b, alpha=ccfg.mixing_alpha)

    def fused_delivery_kwargs(self, ccfg, *, t, t_init) -> dict:
        return {"alpha": ccfg.mixing_alpha}


@register_method
class CoCoDC(OverlappedMethod):
    """CoCoDC: Eq. 9/10 initiation cadence, Algorithm-2 fragment selection,
    Algorithm-1 delay compensation on delivery (with the ACTUAL overlap
    depth), optional per-round Eq. 9 re-derivation from measured T_s."""
    name = "cocodc"
    keeps_snapshot = True
    supports_adaptive_resync = True
    fused_delivery = "compensate"

    def sync_interval(self, eng) -> int:
        return eng.h_cocodc

    def extra_event_step(self, eng, t: int) -> Optional[int]:
        if eng._resync is not None:
            # the outer-round boundary, where Eq. 9 re-derivation runs
            return t + (eng.H - 1 - t) % eng.H
        return None

    def initiate_due(self, eng, t: int, params_stack) -> None:
        if t % eng.h_cocodc == 0:
            busy = {ev.frag for ev in eng.pending}
            if len(busy) < eng.K:
                p = eng._select_cocodc(t, busy)
                eng._initiate(t, params_stack, p)

    def after_deliveries(self, eng, t: int) -> None:
        if eng._resync is not None and (t + 1) % eng.H == 0:
            # end of an outer round: re-derive Eq. 9's N / Eq. 10's h from
            # the measured T_s (the serial scheduler's window mean)
            eng.N, eng.h_cocodc = adaptive_lib.rederive_schedule(
                eng._resync, eng.K, eng.H, eng.topology.t_c,
                eng.cfg.net_utilization, eng._t_s_startup,
                ref_bytes=eng._ref_wire_bytes, lat_s=eng._lat_startup)

    def apply_delivery(self, ccfg, dc_impl, *, local_now, snapshot, g_b,
                       t, t_init):
        return dc_lib.compensate(
            local_now, snapshot, g_b, tau=overlap_depth(t, t_init),
            lam=ccfg.comp_lambda, H=float(ccfg.local_steps),
            sign=ccfg.eq4_sign, impl=dc_impl)

    def fused_delivery_kwargs(self, ccfg, *, t, t_init) -> dict:
        return {"tau": overlap_depth(t, t_init), "lam": ccfg.comp_lambda,
                "H": float(ccfg.local_steps), "sign": ccfg.eq4_sign}
