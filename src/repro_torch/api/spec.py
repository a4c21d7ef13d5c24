"""Declarative experiment specification of the port: a copy of the JAX
package's `repro/api/spec.py` (the same fields, validation, JSON form and
`spec_hash`, so a spec hashes identically in both packages). ONE
serializable object fully determines a cross-region training run.

An `ExperimentSpec` composes four frozen sections:

  * `ModelRef`     — which architecture config, reduced or full
  * `MethodSpec`   — sync-method name + the paper §IV protocol hyperparameters,
    with the beyond-paper knobs split into `MethodExtensions`
  * `NetworkSpec`  — named WAN scenario | generated mesh, link-dynamics spec,
    routed-planner knobs
  * `RunSpec`      — step budget, data/optimizer settings, execution loop,
    checkpoint cadence, seeds

Specs round-trip through JSON exactly (`to_json`/`from_json`), validate
cross-field constraints in ONE place
(`validate`), and expose a stable `spec_hash`: a digest of the
trajectory-determining fields (presentation-only knobs — eval cadence,
checkpoint cadence, loop/engine implementation, labels — are excluded, since
the scanned/per-step and jit/host paths are pinned bitwise-equal). The hash is
written into every checkpoint and replaces the ad-hoc per-key `_traj_meta`
comparison as the primary resume validation.

`repro_torch.launch.train --print-spec` emits the spec any flag combination
maps onto; `--spec path.json` launches from a file, with explicit flags
applied as overrides on top.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from repro_torch.core.methods import get_method
from repro_torch.core.network import MESH_PROFILES, SCENARIOS


@dataclass(frozen=True)
class ModelRef:
    """Reference to a registered architecture config."""
    arch: str = "paper_150m"
    reduced: bool = False            # use the CPU-friendly smoke variant
    compute_dtype: Optional[str] = None   # override (None = the arch default)


@dataclass(frozen=True)
class MethodExtensions:
    """Beyond-paper protocol knobs, split from the §IV hyperparameters so a
    paper-faithful run is `MethodSpec(name=...)` with defaults here."""
    fragment_strategy: str = ""      # "" = strided (Streaming DiLoCo pattern)
    sync_dtype: str = "float32"      # WAN payload dtype (bf16 halves bytes)
    sync_topk_frac: float = 1.0      # top-k sparsification; 1.0 = dense
    link_pricing: bool = False       # Algorithm-2 cost-aware selection
    adaptive_resync: bool = False    # per-round Eq. 9 re-derivation
    wire_codec: str = "none"         # delta wire codec: none | int8 | int4
    codec_block: int = 256           # elements per absmax quantization block
    codec_error_feedback: bool = True  # EF residual folded into next initiation
    fused_updates: bool = False      # flat-plane + kernels/outer_update engine


@dataclass(frozen=True)
class MethodSpec:
    """Sync method (registry name) + paper §IV protocol hyperparameters."""
    name: str = "cocodc"
    num_workers: int = 4             # M
    local_steps: int = 100           # H
    num_fragments: int = 4           # K
    overlap_depth: int = 5           # tau
    mixing_alpha: float = 0.5        # Streaming DiLoCo blending (Eq. 3)
    comp_lambda: float = 0.5         # delay compensation strength (Eq. 7)
    net_utilization: float = 0.4     # gamma (Eq. 9)
    eq4_sign: float = 1.0            # +1 self-consistent; -1 literal Eq. (4)
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    extensions: MethodExtensions = field(default_factory=MethodExtensions)

    def to_cocodc(self, network: "NetworkSpec"):
        """Lower to the core-layer `CoCoDCConfig` (routing knobs live in the
        NetworkSpec but land on the protocol config)."""
        from repro_torch.configs.base import CoCoDCConfig
        ext = self.extensions
        return CoCoDCConfig(
            num_workers=self.num_workers, local_steps=self.local_steps,
            num_fragments=self.num_fragments, overlap_depth=self.overlap_depth,
            mixing_alpha=self.mixing_alpha, comp_lambda=self.comp_lambda,
            net_utilization=self.net_utilization, eq4_sign=self.eq4_sign,
            outer_lr=self.outer_lr, outer_momentum=self.outer_momentum,
            fragment_strategy=ext.fragment_strategy,
            sync_dtype=ext.sync_dtype, sync_topk_frac=ext.sync_topk_frac,
            link_pricing=ext.link_pricing,
            adaptive_resync=ext.adaptive_resync,
            wire_codec=ext.wire_codec, codec_block=ext.codec_block,
            codec_error_feedback=ext.codec_error_feedback,
            fused_updates=ext.fused_updates,
            routing=network.routing, hub_failover=network.hub_failover,
            channel_scheduler=network.channel_scheduler,
            multipath_k=network.multipath_k)


@dataclass(frozen=True)
class NetworkSpec:
    """WAN description: at most one of `topology` (named scenario) or `mesh`
    (generated profile); neither = the calibrated symmetric paper network."""
    topology: Optional[str] = None   # named scenario, or "paper"/None
    mesh: Optional[str] = None       # generated-mesh profile (N = num_workers)
    mesh_seed: int = 0               # mesh generation + dynamics draws
    dynamics: Optional[str] = None   # time-varying link spec (parse_dynamics)
    step_time_s: float = 1.0         # T_c for explicit topologies/meshes
    # bandwidth multiplier: None = leave the mesh's real-world bandwidths;
    # "auto" = calibrate so one mean-fragment collective is bandwidth-
    # dominated at this model's scale (core.network.calibrate_bw_scale);
    # a float overrides either
    bw_scale: Union[float, str, None] = None
    routing: str = "static"          # "routed" = multi-hop planned collectives
    hub_failover: bool = False       # re-elect the hub while its links are out
    # WAN traffic plane: "serial" = channel queue (bitwise-pinned default);
    # "fairshare" = max-min water-filling over all in-flight transfers
    channel_scheduler: str = "serial"
    multipath_k: int = 1             # k edge-disjoint paths per logical link
    # serial scheduler's WAN channel pool (explicit networks only)
    concurrent_collectives: int = 1

    @property
    def explicit(self) -> bool:
        """True when the spec names a non-default network."""
        return self.mesh is not None or self.topology not in (None, "paper")


@dataclass(frozen=True)
class RunSpec:
    """Execution budget and run-level knobs."""
    steps: int = 200
    seed: int = 0
    local_batch: int = 4
    seq_len: int = 64
    inner_lr: float = 4e-4
    warmup_steps: Optional[int] = None   # None = max(10, steps // 20)
    weight_decay: float = 0.1
    noniid_frac: float = 0.25
    eval_batch: int = 16
    eval_every: int = 50
    ckpt_every: int = 0              # 0 = only a final checkpoint (if any)
    loop: str = "segment"            # segment-scanned vs per_step (bitwise)
    engine_impl: str = "jit"         # jitted vs eager transitions (bitwise)
    max_segment: int = 64

    @property
    def resolved_warmup(self) -> int:
        return (self.warmup_steps if self.warmup_steps is not None
                else max(10, self.steps // 20))

    def to_trainer_config(self, method: str):
        from repro_torch.core.trainer import TrainerConfig
        return TrainerConfig(
            method=method, local_batch=self.local_batch, seq_len=self.seq_len,
            total_steps=self.steps, inner_lr=self.inner_lr,
            warmup_steps=self.resolved_warmup,
            weight_decay=self.weight_decay, eval_batch=self.eval_batch,
            seed=self.seed, noniid_frac=self.noniid_frac,
            engine_impl=self.engine_impl, loop=self.loop,
            max_segment=self.max_segment)


_SECTIONS = {"model": ModelRef, "method": MethodSpec, "network": NetworkSpec,
             "run": RunSpec}

# fields that do NOT determine the training trajectory (eval/checkpoint
# cadence and the two execution-path knobs whose variants are pinned
# bitwise-equal) — excluded from spec_hash so e.g. resuming with a different
# eval cadence is not rejected
_VOLATILE_RUN_FIELDS = ("eval_batch", "eval_every", "ckpt_every", "loop",
                        "engine_impl", "max_segment")


def _coerce(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Cast JSON numbers onto the dataclass field types (an int in a float
    field would survive construction but break hash stability)."""
    hints = typing.get_type_hints(cls)
    out = {}
    for k, v in kwargs.items():
        t = hints.get(k)
        if t is float and v is not None:
            v = float(v)
        elif t is int and v is not None:
            v = int(v)
        elif t == Optional[int] and v is not None:
            v = int(v)
        elif t == Optional[float] and v is not None:
            v = float(v)
        elif t == Union[float, str, None] and isinstance(v, int) \
                and not isinstance(v, bool):
            v = float(v)
        out[k] = v
    return out


def _from_section(cls, d: Dict[str, Any], where: str):
    if not isinstance(d, dict):
        raise ValueError(f"spec section {where!r} must be an object, "
                         f"got {type(d).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown spec field(s) in {where!r}: {unknown}; "
                         f"known: {sorted(known)}")
    kwargs = dict(d)
    if cls is MethodSpec and "extensions" in kwargs:
        kwargs["extensions"] = _from_section(
            MethodExtensions, kwargs["extensions"] or {}, "method.extensions")
    return cls(**_coerce(cls, kwargs))


@dataclass(frozen=True)
class ExperimentSpec:
    """The one way to define an experiment: serializable, validated,
    hashable. Build a trainer from it with `repro_torch.api.build_experiment`."""
    model: ModelRef = field(default_factory=ModelRef)
    method: MethodSpec = field(default_factory=MethodSpec)
    network: NetworkSpec = field(default_factory=NetworkSpec)
    run: RunSpec = field(default_factory=RunSpec)
    name: str = ""                   # label (scenario name, sweep id, ...)
    note: str = ""                   # free-form description

    # ------------------------------------------------------------ validation

    def validate(self) -> "ExperimentSpec":
        """Cross-field validation; raises ValueError with an actionable
        message. Returns self so `spec.validate()` chains."""
        def fail(msg):
            raise ValueError(f"invalid ExperimentSpec: {msg}")

        # method must be registered (raises listing registered methods)
        impl = get_method(self.method.name)
        from repro_torch.configs import ARCH_IDS, canonical
        try:
            canonical(self.model.arch)
        except KeyError:
            fail(f"unknown arch {self.model.arch!r}; known: {sorted(ARCH_IDS)}")
        n = self.network
        if n.mesh is not None and n.topology is not None:
            fail("network.mesh and network.topology are mutually exclusive "
                 "(--mesh/--topology)")
        if n.mesh is not None and n.mesh not in MESH_PROFILES:
            fail(f"unknown mesh profile {n.mesh!r}; "
                 f"options: {sorted(MESH_PROFILES)}")
        if n.topology not in (None, "paper") and n.topology not in SCENARIOS:
            fail(f"unknown topology scenario {n.topology!r}; "
                 f"options: paper, {', '.join(sorted(SCENARIOS))}")
        if n.routing not in ("static", "routed"):
            fail(f"network.routing must be 'static' or 'routed', "
                 f"got {n.routing!r}")
        if n.routing == "routed" and not n.explicit:
            fail("network.routing='routed' requires an explicit topology or "
                 "mesh (multi-hop planning over the calibrated symmetric "
                 "default is a no-op)")
        if n.hub_failover and n.routing != "routed":
            fail("network.hub_failover requires network.routing='routed'")
        if n.channel_scheduler not in ("serial", "fairshare"):
            fail(f"network.channel_scheduler must be 'serial' or 'fairshare', "
                 f"got {n.channel_scheduler!r}")
        if n.multipath_k < 1:
            fail(f"network.multipath_k must be >= 1, got {n.multipath_k}")
        if n.multipath_k > 1 and n.routing != "routed":
            fail("network.multipath_k > 1 requires network.routing='routed' "
                 "(k-path splitting needs the route planner)")
        if n.concurrent_collectives < 1:
            fail(f"network.concurrent_collectives must be >= 1, "
                 f"got {n.concurrent_collectives}")
        if n.concurrent_collectives != 1 and not n.explicit:
            fail("network.concurrent_collectives requires an explicit "
                 "topology or mesh (the calibrated paper default is "
                 "single-channel)")
        if n.concurrent_collectives != 1 and \
                n.channel_scheduler == "fairshare":
            fail("network.concurrent_collectives applies to the serial "
                 "scheduler only (fairshare shares links, not channels)")
        if isinstance(n.bw_scale, str) and n.bw_scale != "auto":
            fail(f"network.bw_scale must be a number, null, or 'auto', "
                 f"got {n.bw_scale!r}")
        if self.method.extensions.adaptive_resync and \
                not impl.supports_adaptive_resync:
            fail(f"method.extensions.adaptive_resync requires a method with "
                 f"Eq. 9 re-derivation (method {self.method.name!r} has a "
                 f"fixed cadence)")
        strategies = ("", "strided", "contiguous", "skewed")
        if self.method.extensions.fragment_strategy not in strategies:
            fail(f"unknown fragment_strategy "
                 f"{self.method.extensions.fragment_strategy!r}; "
                 f"options: {strategies}")
        ext = self.method.extensions
        if ext.wire_codec not in ("none", "int8", "int4"):
            fail(f"method.extensions.wire_codec must be 'none', 'int8' or "
                 f"'int4', got {ext.wire_codec!r}")
        if not (2 <= ext.codec_block <= (1 << 16)) or ext.codec_block % 2:
            fail(f"method.extensions.codec_block must be an even integer in "
                 f"[2, 65536] (int4 packs element pairs), "
                 f"got {ext.codec_block}")
        if ext.fused_updates and impl.overlapped and not impl.fused_delivery:
            fail(f"method.extensions.fused_updates requires a fused delivery "
                 f"mode on the method; {self.method.name!r} defines none "
                 f"(set SyncMethod.fused_delivery to 'blend' or 'compensate')")
        if self.run.loop not in ("segment", "per_step"):
            fail(f"run.loop must be 'segment' or 'per_step', "
                 f"got {self.run.loop!r}")
        if self.run.engine_impl not in ("jit", "host"):
            fail(f"run.engine_impl must be 'jit' or 'host', "
                 f"got {self.run.engine_impl!r}")
        for attr, lo in (("steps", 1), ("local_batch", 1), ("seq_len", 1)):
            if getattr(self.run, attr) < lo:
                fail(f"run.{attr} must be >= {lo}")
        for attr, lo in (("num_workers", 2), ("local_steps", 1),
                         ("num_fragments", 1), ("overlap_depth", 0)):
            if getattr(self.method, attr) < lo:
                fail(f"method.{attr} must be >= {lo}")
        return self

    # --------------------------------------------------------- serialization

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        if not isinstance(d, dict):
            raise ValueError(f"spec must be an object, got {type(d).__name__}")
        known = set(_SECTIONS) | {"name", "note"}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown top-level spec field(s): {unknown}; "
                             f"known: {sorted(known)}")
        kwargs: Dict[str, Any] = {
            key: _from_section(scls, d.get(key) or {}, key)
            for key, scls in _SECTIONS.items()}
        kwargs["name"] = str(d.get("name", ""))
        kwargs["note"] = str(d.get("note", ""))
        return cls(**kwargs)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_json_file(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    # ----------------------------------------------------------------- hash

    def traj_dict(self) -> Dict[str, Any]:
        """The trajectory-determining subset of the spec: everything except
        labels and the presentation/cadence fields in `_VOLATILE_RUN_FIELDS`
        (whose variants are pinned bitwise-equal or read-only). Derived
        fields are canonicalized (warmup_steps=None hashes as its resolved
        value, so an explicitly-stated equal warmup matches)."""
        # route through from_dict so a directly-constructed spec holding an
        # int in a float field (e.g. mixing_alpha=1) hashes identically to
        # its own JSON round-trip (_coerce runs only on from_dict)
        canon = ExperimentSpec.from_dict(self.to_dict())
        d = canon.to_dict()
        d.pop("name"), d.pop("note")
        for k in _VOLATILE_RUN_FIELDS:
            d["run"].pop(k)
        d["run"]["warmup_steps"] = canon.run.resolved_warmup
        return d

    @property
    def spec_hash(self) -> str:
        """Stable digest of `traj_dict` — written into checkpoints and
        compared on resume: equal hashes guarantee the resumed run replays
        the saved run's exact trajectory."""
        canon = json.dumps(self.traj_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]


def diff_specs(a: Dict[str, Any], b: Dict[str, Any],
               prefix: str = "") -> "list[str]":
    """Dotted-path description of where two spec dicts differ (for resume
    mismatch errors)."""
    out = []
    for k in sorted(set(a) | set(b)):
        path = f"{prefix}{k}"
        va, vb = a.get(k), b.get(k)
        if isinstance(va, dict) and isinstance(vb, dict):
            out.extend(diff_specs(va, vb, prefix=path + "."))
        elif va != vb:
            out.append(f"{path}: {va!r} != {vb!r}")
    return out
