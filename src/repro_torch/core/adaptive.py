"""CoCoDC adaptive transmission (paper §III-B: Eqs. 9-12, Algorithm 2): a
copy of the JAX package's `repro/core/adaptive.py` (pure Python), kept here
so the port imports nothing of it.

Decides how often to initiate fragment syncs (Eq. 9/10) and which fragment goes
next (Algorithm 2). The decision is a pure function of globally shared history
(completed-sync steps and ||Delta^g_p|| metrics), so every worker computes the same
schedule with zero coordination messages — exactly the paper's determinism claim.

``ResyncState`` extends the same contract to a time-varying network: Eq. 9
derives the target sync count N from T_s, but on dynamic links the startup
T_s goes stale (a diurnal trough or outage can double it). The engine feeds
the MEASURED durations of completed transfers — shared history, identical on
every replica — into a bounded window, and re-derives N (and Eq. 10's h) once
per outer round from the window mean.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass
class AdaptiveState:
    """Shared (deterministically replicated) scheduler state."""
    K: int
    H: int
    # last completed-sync step per fragment (t_{p,b}); -inf-ish before first
    # sync. Empty = derive the defaults from K/H below (a dataclass default
    # cannot see sibling fields, so the fill-in happens in __post_init__).
    last_sync: List[int] = dataclasses.field(default_factory=list)
    # change-rate metric R_p (Eq. 11); fragments never synced get +inf priority
    rate: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.last_sync:
            self.last_sync = [-self.H] * self.K
        if not self.rate:
            self.rate = [math.inf] * self.K


def target_syncs(K: int, H: int, t_c: float, t_s: float, gamma: float) -> int:
    """Eq. 9: N = max(K, floor(gamma * H * T_c / T_s))."""
    if t_s <= 0:
        return K
    return max(K, math.floor(gamma * H * t_c / t_s))


def sync_interval(H: int, N: int) -> int:
    """Eq. 10: h = floor(H / N) local steps between initiations."""
    return max(1, H // N)


@dataclasses.dataclass
class ResyncState:
    """Bounded window of MEASURED fragment-transfer durations (wall seconds,
    queueing excluded) used to re-derive Eq. 9's N when link dynamics shift
    the real T_s away from the startup estimate. The window contents are
    shared history (transfer completions every replica observes), so the
    re-derivation inherits Algorithm 2's zero-coordination determinism; the
    engine serializes the window for exact checkpoint/resume."""
    window: int = 8
    measured: List[float] = dataclasses.field(default_factory=list)
    # wire bytes paired with each measured duration (0 = size unknown, e.g.
    # a pre-v6 checkpoint window) — the latency/bandwidth decomposition input
    measured_bytes: List[float] = dataclasses.field(default_factory=list)

    def observe(self, t_s: float, nbytes: float = 0.0):
        """Record one completed transfer's measured duration (and its wire
        bytes, when known)."""
        self.measured.append(float(t_s))
        self.measured_bytes.append(float(nbytes))
        del self.measured[:-self.window]
        del self.measured_bytes[:-self.window]

    @property
    def t_s_estimate(self) -> Optional[float]:
        """Window-mean measured T_s; None until the first completion."""
        if not self.measured:
            return None
        return sum(self.measured) / len(self.measured)

    def decomposed_t_s(self, ref_bytes: float,
                       lat_s: float = 0.0) -> Optional[float]:
        """Latency/bandwidth decomposition of the window: least-squares fit
        ``T ~= a + m * bytes`` over the (bytes, duration) samples and return
        the BANDWIDTH-only cost ``ref_bytes * m`` of a reference payload.
        Eq. 9's gamma budget then prices link occupancy rather than
        propagation delay — under congestion (fair-share contention) the
        slope steepens and the cadence backs off, while pure latency inflation
        no longer suppresses syncs that cost almost no bandwidth.

        The slope needs spread to identify: with < 3 sized samples, < 5%
        byte spread, or a non-positive fitted slope, fall back to anchoring
        the intercept at the KNOWN propagation latency ``lat_s``
        (m = mean((T - lat_s)/bytes)). None when no sample carries a size."""
        pairs = [(b, t) for b, t in zip(self.measured_bytes, self.measured)
                 if b > 0.0]
        if not pairs:
            return None
        n = len(pairs)
        mb = sum(b for b, _ in pairs) / n
        mt = sum(t for _, t in pairs) / n
        var = sum((b - mb) ** 2 for b, _ in pairs)
        slope = None
        spread = max(b for b, _ in pairs) - min(b for b, _ in pairs)
        if n >= 3 and var > 0.0 and spread > 0.05 * mb:
            m = sum((b - mb) * (t - mt) for b, t in pairs) / var
            if m > 0.0:
                slope = m
        if slope is None:
            slope = sum(max(t - lat_s, 0.0) / b for b, t in pairs) / n
        return float(ref_bytes) * slope


def rederive_schedule(resync: ResyncState, K: int, H: int, t_c: float,
                      gamma: float, fallback_t_s: float, *,
                      decompose: bool = False, ref_bytes: float = 0.0,
                      lat_s: float = 0.0) -> Tuple[int, int]:
    """Eq. 9/10 against the measured T_s (startup estimate until the first
    transfer completes): returns (N, h) for the next outer round.

    ``decompose=True`` replaces the raw window mean with the
    latency/bandwidth decomposition (`ResyncState.decomposed_t_s`): T_s
    becomes the bandwidth-only cost of a `ref_bytes` payload, so the derived
    cadence responds to congestion rather than propagation delay. The default
    keeps the window-mean arithmetic byte-for-byte."""
    if decompose:
        t_bw = None if resync is None else resync.decomposed_t_s(ref_bytes,
                                                                 lat_s)
        if t_bw is None:
            t_bw = max(fallback_t_s - lat_s, 0.0)
        # floor keeps N finite on latency-dominated links (t_bw -> 0 would
        # otherwise degenerate Eq. 9 to its K guard)
        n = target_syncs(K, H, t_c, max(t_bw, 1e-9), gamma)
        return n, sync_interval(H, n)
    t_s = resync.t_s_estimate
    if t_s is None:
        t_s = fallback_t_s
    n = target_syncs(K, H, t_c, t_s, gamma)
    return n, sync_interval(H, n)


def update_rate(state: AdaptiveState, p: int, delta_norm: float, t_complete: int):
    """Eq. 11 on sync completion: R_p = ||Delta^g_p||_2 / I_p with
    I_p = t_complete - t_{p,b}."""
    interval = max(1, t_complete - state.last_sync[p])
    state.rate[p] = float(delta_norm) / interval
    state.last_sync[p] = t_complete


def select_fragment(state: AdaptiveState, t_current: int,
                    in_flight: Optional[set] = None,
                    costs: Optional[List[float]] = None) -> int:
    """Algorithm 2. in_flight fragments are excluded (can't double-send one
    fragment's all-reduce on the single WAN channel).

    `costs` (optional) prices fragments per WAN transfer: costs[p] is the
    simulated seconds one sync of fragment p occupies the topology's
    bottleneck links, so the priority becomes change-rate per WAN-second
    (R_p / cost_p) instead of raw R_p. Under a heterogeneous topology this
    prefers cheap fragments when rates are comparable; with uniform costs it
    reduces exactly to Eq. 12."""
    in_flight = in_flight or set()
    candidates = [p for p in range(state.K) if p not in in_flight]
    if not candidates:
        raise ValueError("all fragments in flight")
    # anti-starvation: any fragment idle >= H steps goes first (lowest idx wins,
    # deterministic)
    for p in candidates:
        if t_current - state.last_sync[p] >= state.H:
            return p

    def priority(p: int) -> float:
        r = state.rate[p]
        if costs is None:
            return r
        c = max(costs[p], 1e-12)
        return r / c if math.isfinite(r) else r
    # Eq. 12: argmax R_p [/ cost_p] (ties -> lowest index, deterministic)
    best = max(candidates, key=lambda p: (priority(p), -p))
    return best
