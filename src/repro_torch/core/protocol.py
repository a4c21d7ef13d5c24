"""Event-driven cross-region protocol engine (DiLoCo, Streaming DiLoCo,
CoCoDC), the port's counterpart of `repro/core/protocol.py` on the static
network with the serial channel scheduler.

The engine is a THIN HOST WRAPPER: all device state lives in one
`EngineState` (core/engine_state.py) and every device mutation is one
transition call. The wrapper owns only host-side scalars: the simulated WAN
wall-clock, WAN-channel queueing, per-link traffic matrices, and the
deterministic schedule of WHICH fragment goes WHEN — the same float
arithmetic as the JAX engine, so the schedule and every `stats()` value
match it exactly.

Timeline semantics (faithful to the paper):
  * every local step costs T_c;
  * DiLoCo: at t % H == H-1, a BLOCKING full-model all-reduce, outer
    update, and all workers restart from theta^g;
  * Streaming DiLoCo: fragment p's all-reduce is initiated on a fixed
    round-robin schedule (one fragment every H/K steps); on completion:
    outer update of the fragment, then Eq. 3 blending;
  * CoCoDC: initiations every h = H/N steps (Eq. 9/10), fragment chosen by
    Algorithm 2; local fragment snapshot at initiation; on completion: outer
    update, then Algorithm 1 delay compensation; R_p updated (Eq. 11).

A fragment initiated at step t completes at its simulated transfer finish
time: queued behind earlier transfers when every WAN channel is busy, and
paced by the slowest link of the collective.

The host scheduler checkpoints in the JAX package's format (schema v6,
`scheduler_state` / `restore_scheduler`): the fields of features the port
lacks are written with their static-network values.

Out of scope here (each raises NotImplementedError naming its ROADMAP.md
item): routed plans, hub failover, the fair-share scheduler, multipath and
link dynamics — also when a checkpoint needs them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CoCoDCConfig
from repro_torch.core import adaptive as adaptive_lib
from repro_torch.core import engine_state as es
from repro_torch.core.fragments import Fragmenter
from repro_torch.core.methods import get_method
from repro_torch.core.network import Topology, as_topology
from repro_torch.core.tree import ShapeDtype, tree_map
from repro_torch.kernels.delta_codec import ops as codec_ops

NETWORK_TODO = ("link dynamics, routing, fair-share and meshes are not "
                "ported yet (ROADMAP.md, Queue A: 'link dynamics, routing, "
                "fair-share and meshes')")

# Host-scheduler checkpoint schema of the JAX package (its
# `protocol.SCHEDULER_SCHEMA_VERSION`); `upgrade_scheduler_state` reads every
# earlier version:
#   v1 — pending/seq/channel clocks/traffic matrices only
#   v2 — + dynamics clocks (dyn_seq, stall_seconds, n_retries)
#   v3 — + routing/resync blocks, 6-element pending rows (duration)
#   v4 — + explicit schema_version stamp
#   v5 — + wire_bytes_raw (uncompressed payload tally)
#   v6 — + 8-element pending rows (wire bytes, transfer id), sojourn log,
#          fair-share flow set, bytes in the resync window, multipath splits
SCHEDULER_SCHEMA_VERSION = 6

_ROUTING_DEFAULTS = {"plan_time": -1.0, "counted_time": -1.0, "plan_dark": [],
                     "reroutes": 0, "hub_elections": 0}
# N/h None = keep the engine-derived cadence (pre-routing checkpoints)
_RESYNC_DEFAULTS = {"measured": [], "measured_bytes": [], "N": None,
                    "h_cocodc": None}


def upgrade_scheduler_state(st: Dict[str, object]) -> Dict[str, object]:
    """Upgrade a serialized host-scheduler dict of any prior schema version
    to the current one, filling in what the writing code could not have
    known (the JAX package's upgrade rules, field for field)."""
    st = dict(st)
    st.setdefault("dyn_seq", 0)
    st.setdefault("stall_seconds", 0.0)
    st.setdefault("n_retries", 0)
    # pending rows: + duration (v3), + wire bytes (0 = unknown) and
    # transfer id (-1) (v6)
    rows = []
    for r in st["pending"]:
        row = list(r)[:8] + [0.0] * (6 - len(r))
        if len(row) < 7:
            row.append(0)
        if len(row) < 8:
            row.append(-1)
        rows.append(row)
    st["pending"] = rows
    routing = dict(st.get("routing") or {})
    for k, v in _ROUTING_DEFAULTS.items():
        routing.setdefault(k, v)
    st["routing"] = routing
    resync = dict(st.get("resync") or {})
    for k, v in _RESYNC_DEFAULTS.items():
        resync.setdefault(k, v)
    if len(resync["measured_bytes"]) != len(resync["measured"]):
        resync["measured_bytes"] = [0.0] * len(resync["measured"])
    st["resync"] = resync
    # pre-codec checkpoints resume with compression ratio 1
    st.setdefault("wire_bytes_raw", st["bytes_sent"])
    st.setdefault("multipath_splits", 0)
    st.setdefault("transfer_log", [])
    st.setdefault("fairshare", None)
    st["schema_version"] = SCHEDULER_SCHEMA_VERSION
    return st


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (0.0 on empty)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    return float(sorted_vals[min(n - 1, max(0, math.ceil(q * n) - 1))])


@dataclasses.dataclass
class PendingSync:
    """Host-side mirror of one in-flight fragment transfer (scheduling only
    — the payload lives in EngineState.inflight_*)."""
    frag: int
    t_init: int
    deliver_at: int        # step index at which the delivery lands
    finish_time: float     # simulated transfer completion (wall seconds)
    seq: int               # initiation order (stable delivery tie-break)
    duration: float = 0.0  # transfer seconds, queueing excluded
    wire: int = 0          # wire bytes of this transfer
    tid: int = -1          # transfer id (sojourn-log key)


class ProtocolEngine:
    """One engine instance per training run. Device state is `self.state`;
    host methods schedule transitions and account the simulated clock."""

    def __init__(self, method: str, ccfg: CoCoDCConfig, fragmenter: Fragmenter,
                 network, params_stack, *, dc_impl: str = "ref",
                 engine_impl: str = "jit", kernel_impl: str = "auto"):
        self.method_impl = get_method(method)
        if engine_impl not in ("jit", "host"):
            raise ValueError(f"unknown engine_impl {engine_impl!r} "
                             f"(options: jit, host; both run eagerly here)")
        if ccfg.routing not in ("static", "routed"):
            raise ValueError(f"unknown routing mode {ccfg.routing!r} "
                             f"(options: static, routed)")
        if ccfg.channel_scheduler not in ("serial", "fairshare"):
            raise ValueError(
                f"unknown channel_scheduler {ccfg.channel_scheduler!r} "
                f"(options: serial, fairshare)")
        if ccfg.multipath_k < 1:
            raise ValueError(f"multipath_k must be >= 1, "
                             f"got {ccfg.multipath_k}")
        if (ccfg.routing != "static" or ccfg.hub_failover
                or ccfg.channel_scheduler != "serial"
                or ccfg.multipath_k > 1):
            raise NotImplementedError(NETWORK_TODO)
        self.method = method
        self.cfg = ccfg
        self.frag = fragmenter
        self.topology: Topology = as_topology(network)
        self.M = ccfg.num_workers
        self.K = ccfg.num_fragments
        self.H = ccfg.local_steps

        # single-model leaf shapes, so the flat theta_g/momentum planes of
        # fused mode can be viewed as trees (properties below)
        self._model_specs = tree_map(
            lambda a: ShapeDtype(tuple(a.shape[1:]), a.dtype), params_stack)
        self.state = es.init_state(method, ccfg, params_stack,
                                   frag=fragmenter)
        self._fns = es.make_engine_fns(method, ccfg, fragmenter,
                                       dc_impl=dc_impl,
                                       kernel_impl=kernel_impl)

        # Eq. 9/10 scheduling interval; with a wire codec the startup T_s
        # sees the compressed payload (cheaper syncs -> more of them)
        mean_frag_bytes = self.frag.total_bytes / self.K
        t_s = self.topology.t_s(self._wire_bytes(int(mean_frag_bytes))
                                if ccfg.wire_codec != "none"
                                else int(mean_frag_bytes))
        self._t_s_startup = t_s
        self.N = adaptive_lib.target_syncs(self.K, self.H, self.topology.t_c,
                                           t_s, ccfg.net_utilization)
        self.h_cocodc = adaptive_lib.sync_interval(self.H, self.N)
        self.h_stream = max(1, self.H // self.K)
        # per-fragment WAN price (seconds per sync) for Algorithm 2 pricing
        self._frag_cost = [
            self.topology.t_s(self._wire_bytes(self.frag.fragment_bytes(p)))
            for p in range(self.K)]
        self._resync: "adaptive_lib.ResyncState | None" = None
        if ccfg.adaptive_resync and self.method_impl.supports_adaptive_resync:
            self._resync = adaptive_lib.ResyncState()

        # host-side schedule + stats
        self.pending: List[PendingSync] = []
        self._seq = 0
        self.wall_clock = 0.0
        self.comm_seconds = 0.0
        self.bytes_sent = 0
        self.wire_bytes_raw = 0      # uncompressed (f32) payload tally
        self.n_syncs = 0
        self._channel_free = [0.0] * self.topology.concurrent_collectives
        m = self.M
        self.link_bytes = np.zeros((m, m), dtype=np.float64)
        self.link_seconds = np.zeros((m, m), dtype=np.float64)
        # per-transfer sojourn (initiation -> finish, queueing included)
        self._transfer_log: Dict[int, float] = {}
        # Eq. 9 re-derivation anchors
        self._ref_wire_bytes = self._wire_bytes(int(mean_frag_bytes))
        self._lat_startup = self.topology.allreduce_time(0)

    # ------------------------------------------------------------ properties

    def _materialize(self, flat_buf):
        """Flat-plane buffer -> single-model tree (fused_updates only)."""
        dev = flat_buf.device
        tmpl = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=dev), self._model_specs)
        return self.frag.flat.unpack_full(tmpl, flat_buf)

    @property
    def theta_g(self):
        """Consensus model as a tree (a copy under `fused_updates`)."""
        if self.cfg.fused_updates:
            return self._materialize(self.state.theta_g)
        return self.state.theta_g

    @theta_g.setter
    def theta_g(self, value):
        if self.cfg.fused_updates:
            value = self.frag.flat.pack_full(value)
        self.state.theta_g = value

    @property
    def momentum(self):
        if self.cfg.fused_updates:
            return self._materialize(self.state.momentum)
        return self.state.momentum

    @momentum.setter
    def momentum(self, value):
        if self.cfg.fused_updates:
            value = self.frag.flat.pack_full(value)
        self.state.momentum = value

    @property
    def adaptive(self) -> adaptive_lib.AdaptiveState:
        """Host snapshot of the Eq. 11 scheduler state (reads the device)."""
        rate = self.state.rate.cpu().numpy()
        last = self.state.last_sync.cpu().numpy()
        return adaptive_lib.AdaptiveState(
            K=self.K, H=self.H,
            last_sync=[int(x) for x in last],
            rate=[float(r) for r in rate])

    # ------------------------------------------------------------------ utils

    def _wire_bytes(self, nbytes: int) -> int:
        """Bytes that cross the WAN for an `nbytes` f32 fragment: the wire
        codec's codes + per-block scales (which subsume sync_dtype), or
        sync_dtype compression; then top-k sparsification (values +
        indices)."""
        itemsize = es.SYNC_DTYPES[self.cfg.sync_dtype].itemsize
        if self.cfg.wire_codec != "none":
            nbytes = codec_ops.wire_bytes(nbytes // 4,
                                          codec=self.cfg.wire_codec,
                                          block=self.cfg.codec_block)
        elif itemsize < 4:
            nbytes = nbytes * itemsize // 4
        if self.cfg.sync_topk_frac < 1.0:
            nbytes = int(nbytes * min(1.0, 2 * self.cfg.sync_topk_frac))
        return int(nbytes)

    def _schedule_transfer(self, nbytes: int) -> Tuple[float, float]:
        """Queue one collective of `nbytes` (raw f32) on the WAN: applies the
        wire format, grabs the earliest-free channel, accounts per-link
        traffic. Returns ``(finish_wall_time, duration)`` (duration excludes
        queueing)."""
        wire = self._wire_bytes(nbytes)
        tid = self.n_syncs
        ch = min(range(len(self._channel_free)),
                 key=lambda i: self._channel_free[i])
        start = max(self.wall_clock, self._channel_free[ch])
        t_s = self.topology.t_s(wire)
        finish = start + t_s
        self.comm_seconds += t_s
        self.link_seconds += self.topology.link_seconds(wire)
        self.link_bytes += self.topology.link_bytes(wire)
        self._channel_free[ch] = finish
        self.bytes_sent += wire
        self.wire_bytes_raw += int(nbytes)
        self.n_syncs += 1
        self._transfer_log[tid] = finish - self.wall_clock
        return finish, finish - start

    def _deliver_step_for(self, t: int, finish_time: float) -> int:
        """First step whose end-of-step wall-clock covers `finish_time`."""
        t_c = self.topology.t_c
        if t_c <= 0:
            return t + 1
        return max(t + 1, math.ceil(finish_time / t_c - 1e-9) - 1)

    # ------------------------------------------------------------ initiation

    def _initiate(self, t: int, params_stack, p: int):
        nbytes = self.frag.fragment_bytes(p)
        tid = self.n_syncs              # _schedule_transfer's id, pre-bump
        finish, duration = self._schedule_transfer(nbytes)
        self.state = self._fns.initiate(self.state, t, params_stack, p)
        self.pending.append(PendingSync(
            frag=p, t_init=t, deliver_at=self._deliver_step_for(t, finish),
            finish_time=finish, seq=self._seq, duration=duration,
            wire=self._wire_bytes(nbytes), tid=tid))
        self._seq += 1

    def _select_cocodc(self, t: int, busy: set) -> int:
        costs = self._frag_cost if self.cfg.link_pricing else None
        return adaptive_lib.select_fragment(self.adaptive, t, busy, costs=costs)

    # ------------------------------------------------------ event-driven API

    def next_event_step(self, t: int) -> "int | None":
        """Smallest step t' >= t at which `on_step_end(t', ...)` acts; None
        when the method schedules no events."""
        return self.method_impl.next_event_step(self, t)

    def advance_steps(self, n: int):
        """Account wall-clock for `n` quiet local steps (accumulated per step,
        like the per-step loop's repeated `+= t_c`)."""
        for _ in range(n):
            self.wall_clock += self.topology.t_c

    def on_step_end(self, t: int, params_stack):
        """Call after inner step t (0-based): ticks the wall-clock, then the
        method's protocol action. Returns the params stack."""
        self.wall_clock += self.topology.t_c
        return self.method_impl.on_step_end(self, t, params_stack)

    def _process_deliveries(self, t: int, params_stack):
        """Apply every in-flight delivery due at step t (order: deliver_at,
        then initiation seq) and feed measured durations to the Eq. 9
        re-derivation window."""
        due = sorted((ev for ev in self.pending if ev.deliver_at <= t),
                     key=lambda e: (e.deliver_at, e.seq))
        for ev in due:
            self.state, params_stack = self._fns.deliver(
                self.state, t, params_stack, ev.frag)
            self.pending.remove(ev)
            if self._resync is not None:
                self._resync.observe(ev.duration, ev.wire)
        return params_stack

    # ---------------------------------------------------------- checkpointing

    def scheduler_state(self) -> Dict[str, object]:
        """Host-side scheduler state (everything outside `EngineState`) in
        the JAX package's schema v6: the in-flight schedule, channel clocks
        and traffic accounting. The fields of features the port lacks carry
        their static-network values (no dynamics clocks, no routed plan, no
        fair-share flows). The simulated wall-clock lives in the trainer's
        state, not here."""
        return {
            "schema_version": SCHEDULER_SCHEMA_VERSION,
            "pending": [[ev.frag, ev.t_init, ev.deliver_at, ev.finish_time,
                         ev.seq, ev.duration, ev.wire, ev.tid]
                        for ev in self.pending],
            "seq": self._seq,
            "comm_seconds": self.comm_seconds,
            "bytes_sent": self.bytes_sent,
            "wire_bytes_raw": self.wire_bytes_raw,
            "n_syncs": self.n_syncs,
            "channel_free": [float(x) for x in self._channel_free],
            "worker_available": [bool(x) for x in
                                 self.state.worker_available.tolist()],
            "link_bytes": self.link_bytes,
            "link_seconds": self.link_seconds,
            "dyn_seq": 0,
            "stall_seconds": 0.0,
            "n_retries": 0,
            "routing": dict(_ROUTING_DEFAULTS),
            "resync": {
                "measured": ([] if self._resync is None
                             else [float(x) for x in self._resync.measured]),
                "measured_bytes": ([] if self._resync is None else
                                   [float(x)
                                    for x in self._resync.measured_bytes]),
                "N": int(self.N),
                "h_cocodc": int(self.h_cocodc),
            },
            "multipath_splits": 0,
            "transfer_log": [[int(k), float(v)] for k, v
                             in sorted(self._transfer_log.items())],
            "fairshare": None,
        }

    def restore_scheduler(self, st: Dict[str, object]):
        """Inverse of `scheduler_state` (EngineState is restored separately;
        it also carries the availability mask). Takes any prior schema
        version; a checkpoint of a run that used link dynamics, a routed
        plan, fair-share flows or multipath splits raises
        NotImplementedError (ROADMAP.md, Queue A item 3)."""
        st = upgrade_scheduler_state(st)
        routing = st["routing"]
        if (int(st["dyn_seq"]) or float(st["stall_seconds"])
                or int(st["n_retries"]) or st["fairshare"] is not None
                or int(st["multipath_splits"])
                or float(routing["plan_time"]) >= 0.0
                or float(routing["counted_time"]) >= 0.0
                or routing["plan_dark"] or int(routing["reroutes"])
                or int(routing["hub_elections"])):
            raise NotImplementedError(
                "the checkpoint's run used link dynamics, routed plans, "
                "fair-share flows or multipath: " + NETWORK_TODO)
        self.pending = [PendingSync(frag=int(r[0]), t_init=int(r[1]),
                                    deliver_at=int(r[2]),
                                    finish_time=float(r[3]), seq=int(r[4]),
                                    duration=float(r[5]), wire=int(r[6]),
                                    tid=int(r[7]))
                        for r in st["pending"]]
        self._seq = int(st["seq"])
        self.comm_seconds = float(st["comm_seconds"])
        self.bytes_sent = int(st["bytes_sent"])
        self.wire_bytes_raw = int(st["wire_bytes_raw"])
        self.n_syncs = int(st["n_syncs"])
        self._channel_free = [float(x) for x in st["channel_free"]]
        self.link_bytes = np.asarray(st["link_bytes"], dtype=np.float64)
        self.link_seconds = np.asarray(st["link_seconds"], dtype=np.float64)
        resync = st["resync"]
        if self._resync is not None:
            self._resync.measured = [float(x) for x in resync["measured"]]
            self._resync.measured_bytes = [float(x) for x
                                           in resync["measured_bytes"]]
        if resync["N"] is not None:
            self.N = int(resync["N"])
        if resync["h_cocodc"] is not None:
            self.h_cocodc = int(resync["h_cocodc"])
        self._transfer_log = {int(k): float(v) for k, v in st["transfer_log"]}

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        sojourns = sorted(self._transfer_log.values())
        return {
            "wall_clock_s": float(self.wall_clock),
            "comm_seconds": float(self.comm_seconds),
            "bytes_sent": float(self.bytes_sent),
            "wire_bytes_total": float(self.bytes_sent),
            "wire_bytes_raw": float(self.wire_bytes_raw),
            "compression_ratio": float(
                1.0 if self.bytes_sent == 0
                else self.wire_bytes_raw / self.bytes_sent),
            "n_syncs": float(self.n_syncs),
            "mean_transfer_s": float(
                0.0 if self.n_syncs == 0
                else self.comm_seconds / self.n_syncs),
            "overlap_ratio": float(0.0 if self.wall_clock == 0 else
                                   min(1.0, self.comm_seconds / self.wall_clock)),
            "target_syncs_N": float(self.N),
            "busiest_link_bytes": float(self.link_bytes.max(initial=0.0)),
            "busiest_link_seconds": float(self.link_seconds.max(initial=0.0)),
            # static links: no stalls, retries, reroutes or splits
            "stall_seconds": 0.0,
            "stall_fraction": 0.0,
            "n_retries": 0.0,
            "reroutes": 0.0,
            "hub_elections": 0.0,
            "transfer_mean_s": float(np.mean(sojourns)) if sojourns else 0.0,
            "transfer_p50_s": _percentile(sojourns, 0.50),
            "transfer_p95_s": _percentile(sojourns, 0.95),
            "multipath_splits": 0.0,
            "max_link_busy_fraction": float(
                0.0 if self.wall_clock <= 0
                else self.link_seconds.max(initial=0.0) / self.wall_clock),
        }

    def link_stats(self) -> Dict[str, object]:
        """Per-link transfer accounting over the run (region-name keyed)."""
        regions = self.topology.regions
        links = {}
        m = self.M
        wall = float(self.wall_clock)
        for i in range(m):
            for j in range(m):
                if self.link_bytes[i, j] > 0:
                    links[f"{regions[i]}->{regions[j]}"] = {
                        "bytes": float(self.link_bytes[i, j]),
                        "busy_seconds": float(self.link_seconds[i, j]),
                        "busy_fraction": float(
                            0.0 if wall <= 0
                            else self.link_seconds[i, j] / wall),
                    }
        busiest = None
        if links:
            busiest = max(links, key=lambda k: links[k]["busy_seconds"])
        return {"links": links, "busiest_link": busiest,
                "collective": self.topology.collective,
                "routing": self.cfg.routing,
                "hub": int(self.topology.hub),
                "regions": list(regions)}
