"""`build_experiment(spec) -> CrossRegionTrainer`, the port's single trainer
factory (counterpart of `repro/api/build.py`): named scenario or the
calibrated symmetric default, optional bandwidth calibration
(`NetworkSpec.bw_scale="auto"`).

The port trains the dense family on the static network with the serial
channel scheduler, with or without the wire codec; a spec that asks for
anything else raises
NotImplementedError naming its ROADMAP.md item (`check_scope`), never a
silent fallback.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.network import (MESH_TODO, Topology, calibrate_bw_scale,
                                      make_scenario)
from repro_torch.core.protocol import NETWORK_TODO


TRAIN_FAMILY_TODO = ("training the {} family is not ported yet (ROADMAP.md, "
                     "Queue A: 'training of the SSM and hybrid families'); "
                     "the port serves it (repro_torch.launch.serve)")


def check_scope(spec: ExperimentSpec) -> None:
    """Raise NotImplementedError for the spec fields the port does not run
    yet."""
    family = resolve_model(spec).family
    if family != "dense":
        raise NotImplementedError(TRAIN_FAMILY_TODO.format(family))
    n = spec.network
    if n.mesh is not None:
        raise NotImplementedError(MESH_TODO)
    if (n.dynamics or n.routing != "static" or n.hub_failover
            or n.channel_scheduler != "serial" or n.multipath_k > 1):
        raise NotImplementedError(NETWORK_TODO)


def resolve_model(spec: ExperimentSpec):
    """ModelRef -> ModelConfig (reduced variant / dtype override applied)."""
    from repro_torch.configs import get_config
    mcfg = get_config(spec.model.arch)
    if spec.model.reduced:
        mcfg = mcfg.reduced()
    if spec.model.compute_dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=spec.model.compute_dtype)
    return mcfg


@functools.lru_cache(maxsize=None)
def _mean_fragment_bytes_cached(arch: str, reduced: bool,
                                compute_dtype: Optional[str],
                                num_fragments: int) -> int:
    from repro_torch.core.fragments import make_fragmenter
    from repro_torch.models import api as models_api
    mcfg = resolve_model(ExperimentSpec.from_dict(
        {"model": {"arch": arch, "reduced": reduced,
                   "compute_dtype": compute_dtype}}))
    frag = make_fragmenter(mcfg, models_api.param_specs(mcfg), num_fragments)
    return frag.total_bytes // num_fragments


def mean_fragment_bytes(spec: ExperimentSpec) -> int:
    """Mean fragment payload (f32 wire format) of the spec's model under its
    fragment count — the `bw_scale="auto"` calibration input. Shapes only;
    never allocates the model."""
    return _mean_fragment_bytes_cached(
        spec.model.arch, spec.model.reduced, spec.model.compute_dtype,
        spec.method.num_fragments)


def build_network(spec: ExperimentSpec) -> Optional[Topology]:
    """NetworkSpec -> base Topology. None = let the trainer build the
    calibrated symmetric paper network."""
    n = spec.network
    if n.mesh is not None:
        raise NotImplementedError(MESH_TODO)
    if n.topology in (None, "paper"):
        return None
    net = make_scenario(n.topology, num_workers=spec.method.num_workers,
                        step_time_s=n.step_time_s)
    scale = n.bw_scale
    if scale == "auto":
        scale = calibrate_bw_scale(net, mean_fragment_bytes(spec))
    if scale is not None and float(scale) != 1.0:
        net = dataclasses.replace(net,
                                  bandwidth_Bps=net.bandwidth_Bps * float(scale))
    if n.concurrent_collectives != 1:
        net = dataclasses.replace(
            net, concurrent_collectives=n.concurrent_collectives)
    return net


def build_experiment(spec: ExperimentSpec, *, device=None, params=None,
                     **trainer_kw):
    """Validate `spec`, check it is in the port's scope, and construct the
    trainer it describes on `device` (CUDA unless named). `params` (numpy or
    torch leaves) overrides the seeded init; `trainer_kw` passes engine
    options (`dc_impl`, `kernel_impl`) through."""
    from repro_torch.core.trainer import CrossRegionTrainer
    spec.validate()
    check_scope(spec)
    mcfg = resolve_model(spec)
    ccfg = spec.method.to_cocodc(spec.network)
    tcfg = spec.run.to_trainer_config(spec.method.name)
    return CrossRegionTrainer(mcfg, ccfg, tcfg, network=build_network(spec),
                              spec=spec, device=device, params=params,
                              **trainer_kw)
