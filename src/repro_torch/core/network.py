"""WAN network + compute model for the cross-region simulation, the static
subset of the JAX package's `repro/core/network.py`, with its float
arithmetic copied verbatim so the simulated clock and traffic stats match
the JAX package's to the bit.

``NetworkModel`` — single-link symmetric model: one latency, one bandwidth,
ring all-reduce over M identical links.

``Topology`` — per-region-pair latency/bandwidth matrices, ring or
hub-and-spoke hierarchical collectives, a bounded number of concurrent WAN
collectives, per-link traffic accounting. Static links only: `LinkDynamics`,
the routed planner (`RoutePlanner`/`CommPlan`), the fair-share scheduler and
the generated meshes are not ported yet (ROADMAP.md, Queue A: 'link
dynamics, routing, fair-share and meshes'); `MESH_PROFILES` keeps their
names so a spec validates as in the JAX package.

All expose the same cost API used by the engines and Eq. 9:
  * ``t_s(bytes)``   — one fragment all-reduce (wall seconds, nominal)
  * ``t_c``          — per-local-step compute time
  * ``tau_steps(b)`` — overlap depth implied by T_s/T_c
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import numpy as np

MESH_TODO = ("generated meshes (--mesh) are not ported yet (ROADMAP.md, "
             "Queue A: 'link dynamics, routing, fair-share and meshes')")
# names of the JAX package's generated-mesh profiles (specs validate
# against them; `api.build_network` raises MESH_TODO for one)
MESH_PROFILES = ("continental", "hub_spoke", "random_geo", "ring")


@dataclasses.dataclass
class NetworkModel:
    num_workers: int = 4
    latency_s: float = 0.15          # WAN RTT-scale latency per all-reduce phase
    bandwidth_Bps: float = 1.25e9    # 10 Gb/s inter-DC
    step_time_s: float = 1.0         # T_c: one local training step

    def allreduce_time(self, nbytes: int) -> float:
        """Ring all-reduce: 2(M-1)/M of the payload crosses each link, plus
        2(M-1) latency hops."""
        m = self.num_workers
        if m <= 1:
            return 0.0
        return 2 * (m - 1) * self.latency_s + (2 * (m - 1) / m) * nbytes / self.bandwidth_Bps

    @property
    def t_c(self) -> float:
        return self.step_time_s

    def t_s(self, nbytes: int) -> float:
        return self.allreduce_time(nbytes)

    def tau_steps(self, nbytes: int) -> int:
        """Overlap depth implied by the network: steps of compute that fit inside
        one fragment all-reduce."""
        return max(1, math.ceil(self.t_s(nbytes) / self.t_c))

    def to_topology(self) -> "Topology":
        """Equivalent symmetric Topology (identical allreduce_time)."""
        return Topology.uniform(self.num_workers, latency_s=self.latency_s,
                                bandwidth_Bps=self.bandwidth_Bps,
                                step_time_s=self.step_time_s)


def paper_network(num_workers: int = 4, *, step_time_s: float = 1.0,
                  fragment_bytes: int | None = None,
                  tau: int = 5) -> NetworkModel:
    """Network calibrated so that T_s = tau * T_c for the given fragment size,
    matching the paper's tau=5, N=8 (gamma=0.4, H=100) setting."""
    if fragment_bytes is None or num_workers <= 1:
        return NetworkModel(num_workers=num_workers, step_time_s=step_time_s)
    m = num_workers
    target_ts = tau * step_time_s
    lat = 0.1 * target_ts / (2 * (m - 1))          # 10% latency, 90% bandwidth
    bw = (2 * (m - 1) / m) * fragment_bytes / (0.9 * target_ts)
    return NetworkModel(num_workers=m, latency_s=lat, bandwidth_Bps=bw,
                        step_time_s=step_time_s)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable description + cost model of a heterogeneous inter-region WAN.

    latency_s / bandwidth_Bps are dense (M, M) matrices over *directed* links
    (diag ignored). ``collective`` picks the all-reduce algorithm:
      * "ring"         — fixed ring 0 -> 1 -> ... -> M-1 -> 0; 2(M-1) phases of
                         nbytes/M chunks, each phase paced by the slowest link.
      * "hierarchical" — reduce-to-hub then broadcast; both halves paced by the
                         slowest spoke link (concurrent spoke transfers).
    ``concurrent_collectives`` bounds how many fragment all-reduces the WAN
    carries at once; the engine queues the excess (contention -> later
    delivery). Static links only: the JAX package's time-varying
    ``dynamics`` layer is not ported yet. Mutable transfer-schedule state
    lives in the engine, not here.
    """
    latency_s: np.ndarray
    bandwidth_Bps: np.ndarray
    step_time_s: float = 1.0
    regions: Tuple[str, ...] = ()
    collective: str = "ring"
    hub: int = 0
    concurrent_collectives: int = 1

    def __post_init__(self):
        lat = np.asarray(self.latency_s, dtype=np.float64)
        bw = np.asarray(self.bandwidth_Bps, dtype=np.float64)
        if lat.shape != bw.shape or lat.ndim != 2 or lat.shape[0] != lat.shape[1]:
            raise ValueError(f"latency/bandwidth must be square & congruent, "
                             f"got {lat.shape} vs {bw.shape}")
        if self.collective not in ("ring", "hierarchical"):
            raise ValueError(f"unknown collective {self.collective!r}")
        if int(self.concurrent_collectives) < 1:
            raise ValueError(
                f"concurrent_collectives must be >= 1 (the serial scheduler "
                f"needs at least one WAN channel), got "
                f"{self.concurrent_collectives}")
        object.__setattr__(self, "latency_s", lat)
        object.__setattr__(self, "bandwidth_Bps", bw)
        if not self.regions:
            object.__setattr__(
                self, "regions",
                tuple(f"region{i}" for i in range(lat.shape[0])))

    # ------------------------------------------------------------- properties

    @property
    def num_workers(self) -> int:
        return self.latency_s.shape[0]

    @property
    def t_c(self) -> float:
        return self.step_time_s

    # ----------------------------------------------------------- cost models

    def _links(self):
        """Directed links the collective uses."""
        m = self.num_workers
        if m <= 1:
            return []
        if self.collective == "ring":
            return [(i, (i + 1) % m) for i in range(m)]
        h = self.hub
        out = []
        for i in range(m):
            if i != h:
                out.extend([(i, h), (h, i)])
        return out

    def allreduce_time(self, nbytes: int) -> float:
        m = self.num_workers
        if m <= 1:
            return 0.0
        if self.collective == "ring":
            chunk = nbytes / m
            phase = max(self.latency_s[i, j] + chunk / self.bandwidth_Bps[i, j]
                        for i, j in self._links())
            return 2 * (m - 1) * phase
        h = self.hub
        gather = max(self.latency_s[i, h] + nbytes / self.bandwidth_Bps[i, h]
                     for i in range(m) if i != h)
        bcast = max(self.latency_s[h, i] + nbytes / self.bandwidth_Bps[h, i]
                    for i in range(m) if i != h)
        return gather + bcast

    def t_s(self, nbytes: int) -> float:
        return self.allreduce_time(nbytes)

    def tau_steps(self, nbytes: int) -> int:
        return max(1, math.ceil(self.t_s(nbytes) / self.t_c))

    # ------------------------------------------------------ per-link traffic

    def link_bytes(self, nbytes: int) -> np.ndarray:
        """(M, M) bytes each directed link carries for ONE collective of
        payload `nbytes` (ring: 2(M-1) chunks of nbytes/M per ring link;
        hierarchical: the full payload up and down each spoke)."""
        m = self.num_workers
        out = np.zeros((m, m), dtype=np.float64)
        if m <= 1:
            return out
        if self.collective == "ring":
            per_link = 2 * (m - 1) * nbytes / m
            for i, j in self._links():
                out[i, j] += per_link
        else:
            for i, j in self._links():
                out[i, j] += nbytes
        return out

    def link_seconds(self, nbytes: int) -> np.ndarray:
        """(M, M) busy-seconds per directed link for one collective (its own
        serialization + latency cost; bottleneck links show the largest)."""
        m = self.num_workers
        out = np.zeros((m, m), dtype=np.float64)
        if m <= 1:
            return out
        if self.collective == "ring":
            chunk = nbytes / m
            for i, j in self._links():
                out[i, j] += 2 * (m - 1) * (
                    self.latency_s[i, j] + chunk / self.bandwidth_Bps[i, j])
        else:
            for i, j in self._links():
                out[i, j] += self.latency_s[i, j] + nbytes / self.bandwidth_Bps[i, j]
        return out

    # ------------------------------------------------------------- mutations

    def degrade_link(self, i: int, j: int, *, bandwidth_factor: float = 1.0,
                     extra_latency_s: float = 0.0,
                     symmetric: bool = True) -> "Topology":
        """A flaky/degraded link scenario: returns a new Topology with link
        (i, j) (and (j, i) when symmetric) slowed down."""
        lat = self.latency_s.copy()
        bw = self.bandwidth_Bps.copy()
        pairs = [(i, j), (j, i)] if symmetric else [(i, j)]
        for a, b in pairs:
            lat[a, b] += extra_latency_s
            bw[a, b] *= bandwidth_factor
        return dataclasses.replace(self, latency_s=lat, bandwidth_Bps=bw)

    # ----------------------------------------------------------- constructors

    @classmethod
    def uniform(cls, num_workers: int, *, latency_s: float = 0.15,
                bandwidth_Bps: float = 1.25e9, step_time_s: float = 1.0,
                **kw) -> "Topology":
        m = num_workers
        lat = np.full((m, m), latency_s); np.fill_diagonal(lat, 0.0)
        bw = np.full((m, m), bandwidth_Bps); np.fill_diagonal(bw, np.inf)
        return cls(latency_s=lat, bandwidth_Bps=bw, step_time_s=step_time_s,
                   **kw)


def as_topology(net) -> Topology:
    """Normalize NetworkModel | Topology -> Topology."""
    if isinstance(net, Topology):
        return net
    if isinstance(net, NetworkModel):
        return net.to_topology()
    raise TypeError(f"expected NetworkModel or Topology, got {type(net)}")


# ---------------------------------------------------------------------------
# named scenarios (multi-region sweeps)
# ---------------------------------------------------------------------------


def paper_symmetric(num_workers: int = 4, *, step_time_s: float = 1.0,
                    fragment_bytes: Optional[int] = None,
                    tau: int = 5) -> Topology:
    """The paper's setting as a Topology: symmetric mesh calibrated so one
    fragment all-reduce costs tau compute steps."""
    return as_topology(paper_network(num_workers, step_time_s=step_time_s,
                                     fragment_bytes=fragment_bytes, tau=tau))


def four_region_asymmetric(*, step_time_s: float = 1.0,
                           scale: float = 1.0) -> Topology:
    """Asymmetric 4-region mesh: us-east / us-west / eu-west / ap-northeast.
    Latencies are one-way WAN-scale; the transpacific links are the bandwidth
    bottleneck. `scale` multiplies all bandwidths (sweep knob)."""
    regions = ("us-east", "us-west", "eu-west", "ap-northeast")
    lat = np.array([
        [0.000, 0.035, 0.040, 0.085],
        [0.035, 0.000, 0.070, 0.055],
        [0.040, 0.070, 0.000, 0.120],
        [0.085, 0.055, 0.120, 0.000],
    ])
    gbps = np.array([
        [np.inf, 25.0, 10.0, 5.0],
        [25.0, np.inf, 8.0, 8.0],
        [10.0, 8.0, np.inf, 2.5],
        [5.0, 8.0, 2.5, np.inf],
    ])
    return Topology(latency_s=lat, bandwidth_Bps=gbps * 0.125e9 * scale,
                    step_time_s=step_time_s, regions=regions)


def hub_and_spoke(num_workers: int = 4, *, hub: int = 0,
                  spoke_latency_s: float = 0.05,
                  spoke_bandwidth_Bps: float = 1.25e9,
                  step_time_s: float = 1.0) -> Topology:
    """Hierarchical all-reduce through a hub region (e.g. regional DCs homed to
    a central one)."""
    m = num_workers
    lat = np.full((m, m), spoke_latency_s); np.fill_diagonal(lat, 0.0)
    bw = np.full((m, m), spoke_bandwidth_Bps); np.fill_diagonal(bw, np.inf)
    return Topology(latency_s=lat, bandwidth_Bps=bw, step_time_s=step_time_s,
                    collective="hierarchical", hub=hub,
                    regions=tuple(["hub"] + [f"spoke{i}" for i in range(1, m)])
                    if hub == 0 else ())


def transpacific_flaky(*, step_time_s: float = 1.0,
                       bandwidth_factor: float = 0.25,
                       extra_latency_s: float = 0.08) -> Topology:
    """The asymmetric 4-region mesh with a degraded transpacific crossing
    (congestion / partial cable failure). The ring collective traverses
    ap-northeast <-> us-east (links (3,0)/(0,3)), so that is the pair that is
    degraded — flakiness on a link the collective never uses would be
    invisible."""
    return four_region_asymmetric(step_time_s=step_time_s).degrade_link(
        3, 0, bandwidth_factor=bandwidth_factor,
        extra_latency_s=extra_latency_s)


SCENARIOS: Dict[str, Callable[..., Topology]] = {
    "paper": paper_symmetric,
    "asym4": four_region_asymmetric,
    "hub_spoke": hub_and_spoke,
    "transpacific_flaky": transpacific_flaky,
}


def make_scenario(name: str, *, num_workers: int = 4,
                  step_time_s: float = 1.0, **kw) -> Topology:
    """Build a named scenario. Scenarios with a fixed region count (asym4,
    transpacific_flaky) require num_workers == 4."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown topology scenario {name!r}; "
                       f"options: {sorted(SCENARIOS)}")
    fn = SCENARIOS[name]
    if name in ("asym4", "transpacific_flaky"):
        if num_workers != 4:
            raise ValueError(f"{name} is a 4-region scenario "
                             f"(got num_workers={num_workers})")
        return fn(step_time_s=step_time_s, **kw)
    return fn(num_workers, step_time_s=step_time_s, **kw)


# auto-calibration target: bandwidth-seconds of one mean-fragment collective,
# in compute steps (latency is left untouched, so the calibrated transfers
# are bandwidth-dominated by construction — asserted in calibrate_bw_scale)
CALIB_BW_STEPS = 6.0


def calibrate_bw_scale(net: Topology, frag_bytes: int, *,
                       target_steps: float = CALIB_BW_STEPS) -> float:
    """paper_network-style auto-calibration: the bandwidth multiplier that
    makes one `frag_bytes` collective spend `target_steps * T_c` seconds in
    its BANDWIDTH phase on this topology. The bandwidth phase is measured on
    a latency-free copy (on a heterogeneous mesh the collective's bottleneck
    link CHANGES with the scale, so subtracting the latency phases from the
    full cost would calibrate against the wrong link). Latencies are
    untouched, so the calibrated transfer is bandwidth-dominated — asserted,
    because a latency-dominated transfer would hide any link dynamics under
    test. Used by spec-driven experiments (`NetworkSpec.bw_scale="auto"`)
    and the scenario sweep."""
    lat_free = dataclasses.replace(net,
                                   latency_s=np.zeros_like(net.latency_s))
    bw_seconds = lat_free.allreduce_time(frag_bytes)
    if bw_seconds <= 0.0:
        raise AssertionError(
            f"calibration: topology has no bandwidth cost "
            f"({net.num_workers} regions)")
    target = target_steps * net.step_time_s
    lat = net.allreduce_time(0)
    if not target > lat:
        raise AssertionError(
            f"calibrated transfer would be latency-dominated: bandwidth "
            f"target {target:.3f}s <= latency phases {lat:.3f}s")
    return bw_seconds / target
