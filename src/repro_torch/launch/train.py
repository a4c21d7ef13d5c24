"""End-to-end cross-region training driver of the PyTorch port
(counterpart of `repro/launch/train.py`: the same flags, plus --device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper_150m \
        --method cocodc --fused-updates --workers 4 --fragments 4 --H 24 \
        --tau 8 --steps 48 --local-batch 8 --seq-len 256 --eval-every 24 \
        --wire-codec int8 --ckpt run.msgpack --ckpt-every 24

and later the same flags with ``--resume run.msgpack`` (``--stop-at N``
pauses a run at step N; the final state is saved to ``--ckpt``).

Every run is defined by a declarative `ExperimentSpec`: the flags map onto
spec fields, `--spec path.json` launches from a saved spec (explicit flags
override its fields), and `--print-spec` emits the composed spec as JSON
without training. The trainer is built through
`repro_torch.api.build_experiment`. Runs on CUDA unless `--device cpu`.

The port runs the static network with the serial channel scheduler, with
or without the wire codec, and checkpoints and resumes in the JAX package's
format (either package resumes the other's checkpoint). Flags outside it
(--dynamics, --mesh, --routing routed, --hub-failover, --channel-scheduler
fairshare, --multipath-k > 1) raise NotImplementedError naming their
ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from repro_torch.api import (ExperimentSpec, build_experiment,
                             registered_methods)
from repro_torch.checkpoint import load_pytree, restore_like
from repro_torch.core.network import MESH_PROFILES, SCENARIOS
from repro_torch.core.trainer import CKPT_FORMAT
from repro_torch.core.tree import leaves_with_path


def spec_from_args(args) -> ExperimentSpec:
    """Map CLI flags onto an ExperimentSpec. With --spec, the file is the
    base and explicitly-passed flags override its fields; without, the spec
    dataclass defaults are the CLI defaults. (Every flag defaults to None =
    "not passed"; boolean flags are three-state — `--x` / `--no-x` / unset —
    so a spec-file boolean can be cleared from the CLI, e.g.
    `--spec routed.json --method streaming --no-adaptive-resync`.)"""
    spec = (ExperimentSpec.from_json_file(args.spec) if args.spec
            else ExperimentSpec())

    def over(obj, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(obj, **kw) if kw else obj

    model = over(spec.model, arch=args.arch, reduced=args.reduced)
    ext = over(spec.method.extensions,
               fragment_strategy=args.fragment_strategy,
               link_pricing=args.link_pricing,
               adaptive_resync=args.adaptive_resync,
               wire_codec=args.wire_codec,
               codec_block=args.codec_block,
               codec_error_feedback=args.codec_error_feedback,
               fused_updates=args.fused_updates)
    method = over(spec.method, name=args.method, num_workers=args.workers,
                  local_steps=args.H, num_fragments=args.fragments,
                  overlap_depth=args.tau, comp_lambda=args.comp_lambda,
                  net_utilization=args.gamma, mixing_alpha=args.alpha)
    method = dataclasses.replace(method, extensions=ext)
    network = over(spec.network, topology=args.topology, mesh=args.mesh,
                   mesh_seed=args.mesh_seed, dynamics=args.dynamics,
                   step_time_s=args.step_time, routing=args.routing,
                   hub_failover=args.hub_failover,
                   channel_scheduler=args.channel_scheduler,
                   multipath_k=args.multipath_k,
                   concurrent_collectives=args.concurrent_collectives)
    run = over(spec.run, steps=args.steps, seed=args.seed, inner_lr=args.lr,
               local_batch=args.local_batch, seq_len=args.seq_len,
               eval_every=args.eval_every, ckpt_every=args.ckpt_every,
               engine_impl=args.engine_impl, loop=args.loop)
    return dataclasses.replace(spec, model=model, method=method,
                               network=network, run=run)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Cross-region training driver of the PyTorch port. Flag "
                    "defaults are the ExperimentSpec defaults (shown in "
                    "--print-spec); with --spec, flags you pass explicitly "
                    "override the file.")
    ap.add_argument("--spec", default=None,
                    help="launch from a saved ExperimentSpec JSON "
                         "(experiments/specs/*.json); explicit flags override")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the composed ExperimentSpec as JSON and exit "
                         "(feed it back via --spec to reproduce the run)")
    ap.add_argument("--arch", default=None, help="architecture config id "
                    "(default paper_150m)")
    ap.add_argument("--reduced", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="use the reduced smoke variant of the arch (CPU-friendly)")
    ap.add_argument("--method", default=None,
                    choices=sorted(registered_methods()),
                    help="registered sync method (default cocodc)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--H", type=int, default=None, help="local steps per round")
    ap.add_argument("--fragments", type=int, default=None)
    ap.add_argument("--tau", type=int, default=None)
    ap.add_argument("--comp-lambda", type=float, default=None)
    ap.add_argument("--gamma", type=float, default=None)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--local-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--topology", default=None, choices=sorted(SCENARIOS),
                    help="heterogeneous WAN scenario (default: calibrated "
                         "symmetric paper network)")
    ap.add_argument("--mesh", default=None, choices=sorted(MESH_PROFILES),
                    help="generated N-region mesh profile (not ported yet: "
                         "raises)")
    ap.add_argument("--mesh-seed", type=int, default=None,
                    help="seed for --mesh generation and --dynamics draws")
    ap.add_argument("--dynamics", default=None,
                    help="time-varying link dynamics spec (not ported yet: "
                         "raises NotImplementedError)")
    ap.add_argument("--fragment-strategy", default=None,
                    choices=["", "strided", "contiguous", "skewed"],
                    help="model fragmentation strategy ('' = strided)")
    ap.add_argument("--step-time", type=float, default=None,
                    help="T_c seconds per local step for --topology/--mesh "
                         "scenarios")
    ap.add_argument("--engine-impl", default=None, choices=["jit", "host"],
                    help="accepted for parity with the JAX driver; both run "
                         "the transitions eagerly here")
    ap.add_argument("--loop", default=None, choices=["segment", "per_step"],
                    help="event-driven host loop (the engine acts at "
                         "protocol events) vs the engine hook after every "
                         "step; the same trajectory")
    ap.add_argument("--link-pricing", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="Algorithm-2 link-aware fragment pricing (R_p/T_s,p)")
    ap.add_argument("--routing", default=None,
                    choices=["static", "routed"],
                    help="static = fixed ring/hierarchical formulas; routed "
                         "(multi-hop planned collectives) is not ported yet "
                         "and raises")
    ap.add_argument("--hub-failover", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="hub failover under --routing routed (not ported "
                         "yet: raises)")
    ap.add_argument("--channel-scheduler", default=None,
                    choices=["serial", "fairshare"],
                    help="WAN traffic plane: serial = fixed channel queue; "
                         "fairshare is not ported yet and raises")
    ap.add_argument("--multipath-k", default=None, type=int,
                    help="k-path splitting under --routing routed (only 1 is "
                         "ported; more raises)")
    ap.add_argument("--concurrent-collectives", default=None, type=int,
                    help="serial scheduler's WAN channel pool size "
                         "(explicit topologies/meshes only; default 1)")
    ap.add_argument("--adaptive-resync", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="re-derive Eq. 9's target sync count N (and Eq. "
                         "10's h) each outer round from measured transfer "
                         "durations (cocodc)")
    ap.add_argument("--wire-codec", default=None,
                    choices=["none", "int8", "int4"],
                    help="quantize pseudo-gradient deltas before the WAN "
                         "(per-block absmax, kernels/delta_codec); none "
                         "keeps the raw f32/sync_dtype wire")
    ap.add_argument("--codec-block", default=None, type=int,
                    help="elements per quantization block (one f32 scale "
                         "ships per block; default 256)")
    ap.add_argument("--codec-error-feedback", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="keep quantization residuals locally and fold them "
                         "into the next initiation of the same elements "
                         "(EF-SGD; default on)")
    ap.add_argument("--fused-updates", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="route protocol transitions through the flat "
                         "fragment plane + the fused outer-update kernels "
                         "(one launch per fragment per stage; default off = "
                         "per-leaf path)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path: the full run state is saved here "
                         "at the end of the run (and every --ckpt-every "
                         "steps)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="atomically checkpoint the full run state to --ckpt "
                         "every N steps (segment boundaries)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to resume from: a trainer_state_v1 "
                         "checkpoint (of either package) restores the full "
                         "run (exact trajectory); a legacy dict restores "
                         "theta_g/momentum only")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="pause the run at this absolute step (the LR "
                         "schedule still spans the spec's steps); checkpoint "
                         "with --ckpt and continue later with --resume")
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu to run on the "
                         "CPU)")
    return ap


def run(argv=None):
    """Parse `argv`, build the trainer and train; returns the trainer (None
    with --print-spec)."""
    ap = make_parser()
    args = ap.parse_args(argv)
    try:
        spec = spec_from_args(args).validate()
    except (ValueError, OSError) as e:
        ap.error(str(e))
    if args.print_spec:
        print(spec.to_json())
        return None
    if spec.run.ckpt_every and not args.ckpt:
        ap.error("--ckpt-every requires --ckpt (nowhere to save)")

    trainer = build_experiment(spec, device=args.device)
    if args.resume:
        resume(trainer, args.resume)
    t0 = time.time()
    hist = trainer.run(steps=args.stop_at, eval_every=spec.run.eval_every,
                       log=lambda s: print(s, flush=True),
                       ckpt_path=args.ckpt, ckpt_every=spec.run.ckpt_every)
    dt = time.time() - t0
    stats = trainer.engine.stats()
    link_stats = trainer.engine.link_stats()
    print(f"done in {dt:.1f}s host-time; simulated wall "
          f"{stats['wall_clock_s']:.0f}s; comm hidden "
          f"{stats['overlap_ratio']*100:.0f}%", flush=True)
    if link_stats["links"]:
        print("per-link WAN traffic:", flush=True)
        for link, rec in sorted(link_stats["links"].items()):
            print(f"  {link:32s} {rec['bytes']/1e9:9.3f} GB "
                  f"busy {rec['busy_seconds']:8.1f}s "
                  f"({rec['busy_fraction']*100:4.1f}%)", flush=True)
        print(f"  busiest link: {link_stats['busiest_link']}", flush=True)
    if args.ckpt:
        saved = trainer.ckpt_seconds
        trainer.save_checkpoint(args.ckpt)
        print(f"checkpoint (full run state, step {trainer.step}) -> "
              f"{args.ckpt} in {trainer.ckpt_seconds - saved:.1f}s",
              flush=True)
    if args.history_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.history_out)),
                    exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump({"args": vars(args), "spec": spec.to_dict(),
                       "history": hist, "stats": stats,
                       "link_stats": link_stats}, f, indent=1)
        print(f"history -> {args.history_out}")
    return trainer


def resume(trainer, path: str) -> None:
    """Restore `trainer` from `path`: a full-run checkpoint restores the
    whole run state; a legacy dict restores theta_g and the outer momentum
    only, and every worker restarts from the restored consensus."""
    t0 = time.perf_counter()
    state = load_pytree(path)
    if isinstance(state, dict) and state.get("format") == CKPT_FORMAT:
        trainer.restore_checkpoint(path, state=state)
        print(f"resumed full run state from {path} (step {trainer.step}, "
              f"wall {trainer.engine.wall_clock:.0f}s) in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return
    eng = trainer.engine
    eng.theta_g = restore_like(eng.theta_g, state["theta_g"])
    eng.momentum = restore_like(eng.momentum, state["momentum"])
    theta = dict(leaves_with_path(eng.theta_g))
    for path_, leaf in leaves_with_path(trainer.params_stack):
        leaf.copy_(theta[path_][None].expand_as(leaf))
    print(f"resumed (legacy: theta_g/momentum only) from {path} "
          f"(step {state.get('step')})", flush=True)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
