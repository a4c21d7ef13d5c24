"""Protocol-engine device state and its transitions, the port's counterpart
of `repro/core/engine_state.py`.

The host-side `ProtocolEngine` (core/protocol.py) owns WHEN things happen;
this module owns WHAT happens to device state. The JAX package keeps the
state as an immutable pytree and jit-compiles each transition with buffers
donated; here the transitions run eagerly and update the state's tensors IN
PLACE (the engine buffers are full-model sized, and nothing reads their old
values), returning the same `EngineState` object.

State layout (fixed capacity, no Python object queue):
  * `theta_g`, `momentum`      — global model + outer Nesterov momentum
  * `inflight_delta`           — ONE full-model f32 buffer holding the
    averaged pseudo-gradients of every in-flight fragment (fragments are
    disjoint, so their rows never collide)
  * `inflight_snapshot`        — worker-stacked local fragment state at
    initiation (CoCoDC Algorithm 1 input; None for other methods)
  * `inflight_active/t_init`   — (K,) per-fragment in-flight bookkeeping
  * `delta_norm/last_sync/rate`— (K,) adaptive-transmission state (Eq. 11)
  * `worker_available`         — (M,) partial-participation mask
  * `wire_residual`            — the wire codec's error-feedback residual,
    ONE full-model f32 buffer (None unless a codec with EF is on)
Per-leaf mode keeps the buffers as trees of the params' shapes; with
`fused_updates` they are flat fragment planes (`frag.flat`).

Transitions (built by `make_engine_fns`):
  * `initiate(state, t, params_stack, p) -> state`
  * `deliver(state, t, params_stack, p) -> (state, params_stack)`
  * `diloco_round(state, params_stack) -> (state, params_stack)`
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import CoCoDCConfig
from repro_torch.core import outer_opt
from repro_torch.core.fragments import Fragmenter
from repro_torch.core.methods import get_method
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.delta_codec import ops as codec_ops
from repro_torch.kernels.outer_update import ops as ou_ops

SYNC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(a)))


def sparsify(d: torch.Tensor, frac: float) -> torch.Tensor:
    """Top-k magnitude sparsification of each worker's slice of `d`
    (M, ...): keep the elements at least as large as the k-th largest
    magnitude, k = max(1, int(size * frac)) per worker."""
    per = d[0].numel()
    if frac >= 1.0 or per == 0:
        return d
    k = max(1, int(per * frac))
    mag = d.abs()
    thresh = torch.topk(mag.reshape(d.shape[0], -1), k, dim=1).values[:, -1]
    thresh = thresh.reshape((-1,) + (1,) * (d.dim() - 1))
    return torch.where(mag >= thresh, d, torch.zeros((), dtype=d.dtype,
                                                     device=d.device))


def _masked_mean(d, worker_mask):
    maskf = worker_mask.to(torch.float32)
    denom = torch.clamp(maskf.sum(), min=1.0)
    w = maskf.reshape((-1,) + (1,) * (d.dim() - 1)).to(d.dtype)
    return (torch.sum(d * w, dim=0) / denom.to(d.dtype)).to(torch.float32)


def pseudograd_mean(frag_stack, theta_g_frag, worker_mask, *, sync_dtype,
                    topk_frac: float = 1.0):
    """The cross-region collective: mean over AVAILABLE workers of the
    pseudo-gradients (theta^m - theta^g), per leaf. The payload crosses the
    WAN in `sync_dtype`, optionally top-k-sparsified per worker and leaf;
    the result returns to f32."""
    sync_dt = SYNC_DTYPES[sync_dtype]

    def avg(x, g):
        d = (x - g[None]).to(sync_dt)
        if topk_frac < 1.0:
            d = sparsify(d, topk_frac)
        return _masked_mean(d, worker_mask)

    return tree_map(avg, frag_stack, theta_g_frag)


def flat_pseudograd_mean(stack_flat, theta_flat, worker_mask, *, sync_dtype,
                         topk_frac: float = 1.0):
    """`pseudograd_mean` over flat-plane buffers: stack (M, rows, LANES) vs
    global (rows, LANES). Top-k ranks each worker's whole fragment plane as
    ONE pool (the flat-plane semantic of the JAX package)."""
    d = (stack_flat - theta_flat[None]).to(SYNC_DTYPES[sync_dtype])
    if topk_frac < 1.0:
        d = sparsify(d, topk_frac)
    return _masked_mean(d, worker_mask)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineState:
    theta_g: Any
    momentum: Any
    inflight_delta: Any
    inflight_snapshot: Any
    inflight_active: torch.Tensor    # (K,) bool
    inflight_t_init: torch.Tensor    # (K,) int32
    delta_norm: torch.Tensor         # (K,) f32
    last_sync: torch.Tensor          # (K,) int32 — t_{p,b} of Eq. 11
    rate: torch.Tensor               # (K,) f32  — R_p of Eq. 11 (+inf = never)
    worker_available: torch.Tensor   # (M,) bool
    # wire-codec error-feedback residual: one full-model f32 buffer
    # (fragments are disjoint, so their residuals never collide); None
    # unless an active codec has error feedback on
    wire_residual: Any = None


def init_state(method: str, ccfg: CoCoDCConfig, params_stack,
               frag: Fragmenter | None = None) -> EngineState:
    """Initial state from the (identical-per-worker) params stack, on the
    stack's device. With `ccfg.fused_updates` every engine-owned buffer
    lives on the flat plane (`frag` is then required)."""
    K, M, H = ccfg.num_fragments, ccfg.num_workers, ccfg.local_steps
    ef_active = ccfg.wire_codec != "none" and ccfg.codec_error_feedback
    dev = tree_leaves(params_stack)[0].device
    theta_g = tree_map(lambda a: a[0].clone(), params_stack)
    impl = get_method(method)
    if ccfg.fused_updates:
        if frag is None:
            raise ValueError("fused_updates=True needs the Fragmenter (its "
                             "flat plane defines the buffer layout); pass "
                             "frag=")
        theta_g = frag.flat.pack_full(theta_g)
        momentum = frag.flat.full_zeros(device=dev)
        inflight_delta = (frag.flat.full_zeros(device=dev)
                          if impl.overlapped else None)
        inflight_snapshot = (frag.flat.full_zeros(M, device=dev)
                             if impl.keeps_snapshot else None)
        wire_residual = frag.flat.full_zeros(device=dev) if ef_active else None
    else:
        f32_zeros = lambda a: torch.zeros(  # noqa: E731
            a.shape, dtype=torch.float32, device=dev)
        momentum = tree_map(torch.zeros_like, theta_g)
        inflight_delta = (tree_map(f32_zeros, theta_g)
                          if impl.overlapped else None)
        inflight_snapshot = (tree_map(torch.zeros_like, params_stack)
                             if impl.keeps_snapshot else None)
        wire_residual = tree_map(f32_zeros, theta_g) if ef_active else None
    return EngineState(
        theta_g=theta_g,
        momentum=momentum,
        inflight_delta=inflight_delta,
        inflight_snapshot=inflight_snapshot,
        inflight_active=torch.zeros((K,), dtype=torch.bool, device=dev),
        inflight_t_init=torch.zeros((K,), dtype=torch.int32, device=dev),
        delta_norm=torch.zeros((K,), dtype=torch.float32, device=dev),
        last_sync=torch.full((K,), -H, dtype=torch.int32, device=dev),
        rate=torch.full((K,), float("inf"), dtype=torch.float32, device=dev),
        worker_available=torch.ones((M,), dtype=torch.bool, device=dev),
        wire_residual=wire_residual,
    )


def state_to_dict(state: EngineState) -> dict:
    """EngineState -> plain field dict (the checkpoint format of the JAX
    package's `state_to_dict`)."""
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(EngineState)}


def state_from_dict(ref: EngineState, d: dict) -> EngineState:
    """Rebuild an EngineState from `state_to_dict` output (tensors or the
    numpy leaves of a loaded checkpoint), casting every leaf to the dtype,
    shape and device of the matching leaf of `ref`, a live state from
    `init_state`. Fields absent from `d` (`wire_residual` in a pre-codec
    checkpoint restored into a codec engine) keep `ref`'s value: error
    feedback restarts from a zero residual."""
    from repro_torch.checkpoint.io import restore_like
    return EngineState(**{
        f.name: (restore_like(getattr(ref, f.name), d[f.name])
                 if f.name in d else getattr(ref, f.name))
        for f in dataclasses.fields(EngineState)})


# ---------------------------------------------------------------------------
# transitions
# ---------------------------------------------------------------------------


class EngineFns(NamedTuple):
    initiate: Any
    deliver: Any
    diloco_round: Any


def _mask_offline(new_local, old_local, avail):
    return tree_map(
        lambda n, o: torch.where(
            avail.reshape((-1,) + (1,) * (n.dim() - 1)), n, o),
        new_local, old_local)


def _note_delivery(state: EngineState, t: int, p: int) -> None:
    """Eq. 11 bookkeeping of a delivery of fragment p at step t (device
    ops only, no host sync)."""
    interval = torch.clamp(t - state.last_sync[p], min=1).to(torch.float32)
    state.inflight_active[p] = False
    state.rate[p] = state.delta_norm[p] / interval
    state.last_sync[p] = t


def make_engine_fns(method: str, ccfg: CoCoDCConfig, frag: Fragmenter, *,
                    dc_impl: str = "ref",
                    kernel_impl: str = "auto") -> EngineFns:
    """Build the transition functions. The method-specific pieces come from
    the registered `SyncMethod` strategy. `dc_impl` ("ref" | "kernel")
    picks the per-leaf delay compensation; with `ccfg.fused_updates` the
    transitions go through the flat plane and kernels/outer_update.
    `kernel_impl` is the policy of those kernels and of the wire codec's
    (kernels/delta_codec, both layouts): "auto" = the kernels for CUDA
    tensors, "ref" = their plain versions.

    With `ccfg.wire_codec` on, every outgoing delta goes through the codec
    at initiation (and in the blocking round): the in-flight buffer holds
    what the receiver reconstructs from the wire, so `deliver` reads the
    post-wire payload and `delta_norm` is taken from it. With error
    feedback, `d_in = delta + residual`, `delta = roundtrip(d_in)`,
    `residual = d_in - delta`, the residual updated in place."""
    impl = get_method(method)
    lr, mu = ccfg.outer_lr, ccfg.outer_momentum
    codec_on = ccfg.wire_codec != "none"

    def roundtrip(d):
        return codec_ops.codec_roundtrip_array(
            d, codec=ccfg.wire_codec, block=ccfg.codec_block, impl=kernel_impl)

    def tree_roundtrip(d):
        return codec_ops.codec_roundtrip(
            d, codec=ccfg.wire_codec, block=ccfg.codec_block, impl=kernel_impl)

    def initiate(state: EngineState, t, params_stack, p: int) -> EngineState:
        """Start fragment p's all-reduce at step t: snapshot the worker-local
        fragment, park the globally-averaged pseudo-gradient in flight."""
        theta_g_frag = frag.extract(state.theta_g, p)
        frag_stack = frag.extract(params_stack, p, worker_axis=True)
        delta_avg = pseudograd_mean(
            frag_stack, theta_g_frag, state.worker_available,
            sync_dtype=ccfg.sync_dtype, topk_frac=ccfg.sync_topk_frac)
        if codec_on:
            residual = state.wire_residual
            d_in = (delta_avg if residual is None else
                    tree_map(torch.add, delta_avg, frag.extract(residual, p)))
            delta_avg = tree_roundtrip(d_in)
            if residual is not None:
                frag.insert(residual, p,
                            tree_map(torch.sub, d_in, delta_avg))
        if impl.keeps_snapshot:
            frag.insert(state.inflight_snapshot, p, frag_stack,
                        worker_axis=True)
        frag.insert(state.inflight_delta, p, delta_avg)
        state.inflight_active[p] = True
        state.inflight_t_init[p] = t
        state.delta_norm[p] = tree_norm(delta_avg)
        return state

    def deliver(state: EngineState, t, params_stack, p: int):
        """Fragment p's all-reduce completed at step t: outer Nesterov update
        of the global fragment, the strategy's delivery (Eq. 3 blending,
        Algorithm-1 compensation), offline masking, Eq. 11 rate update."""
        delta_avg = frag.extract(state.inflight_delta, p)
        new_g, new_mom = outer_opt.nesterov_update(
            frag.extract(state.theta_g, p), frag.extract(state.momentum, p),
            delta_avg, lr=lr, mu=mu)
        local_now = frag.extract(params_stack, p, worker_axis=True)
        g_b = tree_map(lambda g: g[None], new_g)
        snap = (frag.extract(state.inflight_snapshot, p, worker_axis=True)
                if impl.keeps_snapshot else None)
        new_local = impl.apply_delivery(
            ccfg, dc_impl, local_now=local_now, snapshot=snap, g_b=g_b,
            t=t, t_init=state.inflight_t_init[p])
        # offline workers keep their local state (they re-sync on return)
        new_local = _mask_offline(new_local, local_now,
                                  state.worker_available)
        frag.insert(state.theta_g, p, new_g)
        frag.insert(state.momentum, p, new_mom)
        _note_delivery(state, t, p)
        frag.insert(params_stack, p, new_local, worker_axis=True)
        return state, params_stack

    def diloco_round(state: EngineState, params_stack):
        """Blocking full-model round: all-reduce pseudo-gradients, outer
        update, available workers restart from the new theta^g."""
        delta_avg = pseudograd_mean(
            params_stack, state.theta_g, state.worker_available,
            sync_dtype=ccfg.sync_dtype, topk_frac=ccfg.sync_topk_frac)
        if codec_on:
            residual = state.wire_residual
            d_in = (delta_avg if residual is None else
                    tree_map(torch.add, delta_avg, residual))
            delta_avg = tree_roundtrip(d_in)
            if residual is not None:
                for r, a, b in zip(tree_leaves(residual), tree_leaves(d_in),
                                   tree_leaves(delta_avg)):
                    torch.sub(a, b, out=r)
        new_g, new_mom = outer_opt.nesterov_update(
            state.theta_g, state.momentum, delta_avg, lr=lr, mu=mu)
        avail = state.worker_available
        for leaf, g in zip(tree_leaves(params_stack), tree_leaves(new_g)):
            keep = avail.reshape((-1,) + (1,) * g.dim())
            leaf.copy_(torch.where(keep, g[None], leaf))
        state.theta_g, state.momentum = new_g, new_mom
        return state, params_stack

    if ccfg.fused_updates:
        if impl.overlapped and not impl.fused_delivery:
            raise ValueError(
                f"fused_updates=True: method {method!r} defines no "
                f"fused_delivery mode (kernels/outer_update supports: "
                f"{ou_ops.DELIVER_MODES}); run it with fused_updates=False")
        flat = frag.flat

        def initiate(state: EngineState, t, params_stack, p: int) -> EngineState:  # noqa: F811
            """Fused initiation: theta is already flat (a static row slice);
            pack the worker stack's fragment once, one flat pseudo-gradient
            mean, one codec round trip over the fragment's plane (one
            `quantize_pack` and one `dequantize_unpack` launch), park via
            static row slices."""
            r0, r1 = flat.row_span(p)
            stack_flat = flat.pack_stack(params_stack, p)
            delta = flat_pseudograd_mean(
                stack_flat, state.theta_g[r0:r1], state.worker_available,
                sync_dtype=ccfg.sync_dtype, topk_frac=ccfg.sync_topk_frac)
            if codec_on:
                residual = state.wire_residual
                d_in = delta if residual is None else delta + residual[r0:r1]
                delta = roundtrip(d_in)
                if residual is not None:
                    torch.sub(d_in, delta, out=residual[r0:r1])
            if impl.keeps_snapshot:
                state.inflight_snapshot[:, r0:r1] = stack_flat
            state.inflight_delta[r0:r1] = delta
            state.inflight_active[p] = True
            state.inflight_t_init[p] = t
            state.delta_norm[p] = torch.sqrt(torch.sum(torch.square(delta)))
            return state

        def deliver(state: EngineState, t, params_stack, p: int):  # noqa: F811
            """Fused delivery: ONE `nesterov_2d` launch updates theta and
            momentum, ONE `deliver_2d` launch chains the method's
            blend/compensation with offline masking over the worker stack."""
            r0, r1 = flat.row_span(p)
            new_g, new_mom = ou_ops.outer_nesterov(
                state.theta_g[r0:r1], state.momentum[r0:r1],
                state.inflight_delta[r0:r1], lr=lr, mu=mu, impl=kernel_impl)
            snap = (state.inflight_snapshot[:, r0:r1]
                    if impl.keeps_snapshot else None)
            new_local = ou_ops.fused_deliver(
                flat.pack_stack(params_stack, p), snap, new_g,
                state.worker_available, mode=impl.fused_delivery,
                impl=kernel_impl,
                **impl.fused_delivery_kwargs(
                    ccfg, t=t, t_init=state.inflight_t_init[p]))
            state.theta_g[r0:r1] = new_g
            state.momentum[r0:r1] = new_mom
            _note_delivery(state, t, p)
            flat.unpack_stack(params_stack, p, new_local)
            return state, params_stack

        def diloco_round(state: EngineState, params_stack):  # noqa: F811
            """Fused blocking round: theta/momentum are full-model planes;
            the worker reset is `deliver_2d` at blend alpha=1 (broadcast +
            offline mask in one launch)."""
            stack_flat = flat.pack_full(params_stack, worker_axis=True)
            delta = flat_pseudograd_mean(
                stack_flat, state.theta_g, state.worker_available,
                sync_dtype=ccfg.sync_dtype, topk_frac=ccfg.sync_topk_frac)
            if codec_on:
                residual = state.wire_residual
                d_in = delta if residual is None else delta + residual
                delta = roundtrip(d_in)
                if residual is not None:
                    torch.sub(d_in, delta, out=residual)
            new_g, new_mom = ou_ops.outer_nesterov(
                state.theta_g, state.momentum, delta, lr=lr, mu=mu,
                impl=kernel_impl)
            new_local = ou_ops.fused_deliver(
                stack_flat, None, new_g, state.worker_available,
                mode="blend", alpha=1.0, impl=kernel_impl)
            state.theta_g, state.momentum = new_g, new_mom
            flat.unpack_full(params_stack, new_local, worker_axis=True)
            return state, params_stack

    return EngineFns(initiate=initiate, deliver=deliver,
                     diloco_round=diloco_round)
