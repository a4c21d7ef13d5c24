"""Cross-region trainer of the port (counterpart of `repro/core/trainer.py`):
M worker-stacked inner AdamW loops plus a protocol engine (DiLoCo /
Streaming DiLoCo / CoCoDC) coordinating cross-region synchronization.

Worker-local params and optimizer state carry a leading worker axis M. The
JAX trainer vmaps `value_and_grad` over it; here a loop over the workers
runs each one's forward and backward (on the worker's slice of the stack),
and one AdamW update covers the whole stack. The host loop walks PROTOCOL
EVENTS as the JAX segment loop does: the steps between two events run one
after the other (there is no compile to amortise, so no scan), quiet steps
only advance the simulated clock, and the engine acts at the event step.
`loop="per_step"` (and `train_one_step`) runs the same loop with segments
of one step, so the engine's hook sees every step — the same trajectory,
as the JAX package pins its two loops bitwise.

Initial params come from a seeded `torch.Generator`, or from `params=`
(numpy or torch leaves, e.g. a JAX-package init through
`weights.params_from_jax`) so both packages can start from the same
weights.

Checkpoint/resume: the full run state — `TrainerState` (params stack, inner
AdamW state, EngineState, step/wall-clock/data cursor), the host scheduler
and the eval history — round-trips atomically through `checkpoint/io` at any
segment boundary, in the JAX package's format (`CKPT_FORMAT`, meta schema
v5), so either package resumes the other's checkpoint; a resumed run replays
the uninterrupted one exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import load_pytree, restore_like, save_pytree
from repro_torch.configs.base import CoCoDCConfig, ModelConfig
from repro_torch.core import engine_state as es
from repro_torch.core.fragments import make_fragmenter
from repro_torch.core.network import NetworkModel, Topology, paper_network
from repro_torch.core.protocol import NETWORK_TODO, ProtocolEngine
from repro_torch.core.tree import leaves_with_path, tree_map
from repro_torch.data.pipeline import (MarkovCorpus, make_worker_streams,
                                       stacked_segment)
from repro_torch.kernels import resolve_device
from repro_torch.models import api
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.adamw import AdamWState
from repro_torch.weights import params_from_jax, unflatten


@dataclasses.dataclass
class TrainerConfig:
    method: str = "cocodc"              # diloco | streaming | cocodc | local
    local_batch: int = 8
    seq_len: int = 64
    total_steps: int = 400
    inner_lr: float = 4e-4
    warmup_steps: int = 50
    weight_decay: float = 0.1
    eval_batch: int = 16
    seed: int = 0
    noniid_frac: float = 0.25
    # both run the engine's transitions eagerly here (no jit in the port)
    engine_impl: str = "jit"
    # "segment" = event-driven host loop (the engine acts at event steps
    # only); "per_step" = the same loop in one-step segments (the engine's
    # hook after every step)
    loop: str = "segment"
    # longest run of steps between two host-loop boundaries
    max_segment: int = 64


@dataclasses.dataclass
class TrainerState:
    """Everything device-side a resumed run needs: worker-stacked params and
    inner AdamW state, the protocol EngineState, and the run cursors. The
    host scheduler state rides beside it in the checkpoint dict
    (`CrossRegionTrainer.checkpoint_state`)."""
    params_stack: Any
    opt_state: Any
    engine: es.EngineState
    step: int
    wall_clock: float
    data_cursor: int    # == step (the data is a pure function of the step)


CKPT_FORMAT = "trainer_state_v1"

# Checkpoint-meta schema of the JAX package (`_upgrade_meta` reads every
# earlier version): v2 + spec and spec_hash, v3 + wire-codec knobs, v4 +
# traffic-plane knobs, v5 + fused_updates.
META_SCHEMA_VERSION = 5


class CrossRegionTrainer:
    def __init__(self, model_cfg: ModelConfig, ccfg: CoCoDCConfig,
                 tcfg: TrainerConfig,
                 network: Optional["NetworkModel | Topology"] = None,
                 dynamics: Optional[str] = None, dynamics_seed: int = 0,
                 spec: Optional[Any] = None, *, device=None, params=None,
                 **engine_kw):
        """`engine_kw` (`dc_impl`, `kernel_impl`) passes to the
        `ProtocolEngine`."""
        if dynamics:
            raise NotImplementedError(NETWORK_TODO)
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.ccfg = ccfg
        self.tcfg = tcfg
        self.spec = spec
        M = ccfg.num_workers

        if params is None:
            gen = torch.Generator(self.device).manual_seed(tcfg.seed)
            params = api.init_params(model_cfg, gen, self.device)
        else:
            params = params_from_jax(model_cfg, tree_map(
                lambda a: a.detach().cpu().numpy()
                if isinstance(a, torch.Tensor) else np.asarray(a), params),
                self.device)
        self.params_stack = tree_map(
            lambda a: a[None].repeat((M,) + (1,) * a.dim()), params)
        self.opt_state = adamw_init(self.params_stack)

        self.fragmenter = make_fragmenter(model_cfg, api.param_specs(model_cfg),
                                          ccfg.num_fragments,
                                          strided=ccfg.strided_fragments,
                                          strategy=ccfg.fragment_strategy)
        if network is None:
            network = paper_network(
                M, fragment_bytes=self.fragmenter.total_bytes // ccfg.num_fragments,
                tau=ccfg.overlap_depth)
        self.network = network
        self.engine = ProtocolEngine(tcfg.method, ccfg, self.fragmenter,
                                     network, self.params_stack,
                                     engine_impl=tcfg.engine_impl,
                                     **engine_kw)

        self.streams = make_worker_streams(M, model_cfg.vocab, seed=tcfg.seed,
                                           noniid_frac=tcfg.noniid_frac)
        # held-out IID stream (global backbone) for consensus-model eval
        self.eval_stream = MarkovCorpus(vocab=model_cfg.vocab, seed=tcfg.seed,
                                        worker_id=-1, noniid_frac=0.0)
        self.history: List[Dict] = []
        self.step = 0
        # host seconds in `run` and, of them, in evaluations; both end in a
        # device read (each segment reads its loss), so they are
        # synchronised wall times
        self.run_seconds = 0.0
        self.eval_seconds = 0.0
        # host seconds writing checkpoints (not counted in run_seconds)
        self.ckpt_seconds = 0.0

    def lr(self, step) -> torch.Tensor:
        """Inner LR at `step` (f32 CPU tensor; a scalar or per-step array)."""
        return warmup_cosine(step, base_lr=self.tcfg.inner_lr,
                             warmup_steps=self.tcfg.warmup_steps,
                             total_steps=self.tcfg.total_steps)

    # -------------------------------------------------------------- stepping

    def _inner_step(self, tokens: torch.Tensor, labels: torch.Tensor,
                    lr: torch.Tensor) -> torch.Tensor:
        """One inner AdamW step of every worker on its (B, S) batch slice of
        `tokens`/`labels` (M, B, S). Returns the (M,) losses (on device)."""
        paths = [p for p, _ in leaves_with_path(self.params_stack)]
        stack = dict(leaves_with_path(self.params_stack))
        grads = {p: torch.empty_like(stack[p]) for p in paths}
        losses = []
        for m in range(self.ccfg.num_workers):
            mine = {p: stack[p][m].detach().requires_grad_() for p in paths}
            loss, _ = api.loss_fn(self.mcfg, unflatten(mine),
                                  {"tokens": tokens[m], "labels": labels[m]})
            for p, g in zip(paths, torch.autograd.grad(
                    loss, [mine[p] for p in paths])):
                grads[p][m] = g
            losses.append(loss.detach())
        self.opt_state = adamw_update(unflatten(grads), self.opt_state,
                                      self.params_stack, lr,
                                      weight_decay=self.tcfg.weight_decay)
        return torch.stack(losses)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in
                batch.items()}

    def train_one_step(self) -> float:
        """One inner step, then the engine's hook: a one-step segment."""
        return self._run_segment(self.step, 1)

    def _run_segment(self, t0: int, n: int) -> float:
        """Steps [t0, t0+n): only the last can be a protocol event; the
        quiet ones advance the simulated clock without touching the engine.
        Returns the mean loss of the last step."""
        seg = self._to_device(stacked_segment(self.streams, t0, n,
                                              self.tcfg.local_batch,
                                              self.tcfg.seq_len))
        lrs = self.lr(list(range(t0, t0 + n)))
        for i in range(n):
            losses = self._inner_step(seg["tokens"][i], seg["labels"][i],
                                      lrs[i])
        if n > 1:
            self.engine.advance_steps(n - 1)
        self.params_stack = self.engine.on_step_end(t0 + n - 1,
                                                    self.params_stack)
        self.step = t0 + n
        return float(losses.mean())

    def _segment_end(self, t: int, target: int, eval_every: int,
                     ckpt_every: int = 0) -> int:
        """Last step (inclusive) of the segment starting at t: the earliest
        of the next protocol event, the next eval or checkpoint boundary,
        and the end (`t` itself under `loop="per_step"`)."""
        if self.tcfg.loop == "per_step":
            return t
        end = min(target - 1, t + self.tcfg.max_segment - 1)
        ne = self.engine.next_event_step(t)
        if ne is not None:
            end = min(end, ne)
        for every in (eval_every, ckpt_every):
            if every:
                end = min(end, (t // every + 1) * every - 1)
        return end

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def evaluate(self, n_batches: int = 2) -> Dict[str, float]:
        """Perplexity of the consensus (global) model on the held-out
        stream."""
        theta = self.engine.theta_g
        nll = 0.0
        for i in range(n_batches):
            b = self._to_device(self.eval_stream.batch(
                10_000_000 + i, self.tcfg.eval_batch, self.tcfg.seq_len))
            _, metrics = api.loss_fn(self.mcfg, theta, b)
            nll += float(metrics["nll"])
        nll /= n_batches
        return {"nll": nll, "ppl": float(np.exp(np.float32(nll)))}

    # ------------------------------------------------------------------- run

    def _record_eval(self, train_loss: float, log: Callable[[str], None]):
        t0 = time.perf_counter()
        ev = self.evaluate()
        self.eval_seconds += time.perf_counter() - t0
        rec = {"step": self.step, "train_loss": train_loss, **ev,
               **self.engine.stats()}
        self.history.append(rec)
        log(f"[{self.tcfg.method}] step {self.step:5d} "
            f"train {train_loss:.4f} eval_nll {ev['nll']:.4f} "
            f"ppl {ev['ppl']:.2f} wall {self.engine.wall_clock:.0f}s")

    def run(self, steps: Optional[int] = None, eval_every: int = 50,
            log: Callable[[str], None] = lambda s: None,
            ckpt_path: Optional[str] = None, ckpt_every: int = 0):
        """Train to absolute step `steps` (default tcfg.total_steps; a
        resumed trainer continues from its restored cursor), recording an
        eval every `eval_every` steps and at the end. With `ckpt_path` and
        `ckpt_every`, checkpoints the full run state atomically at those
        segment boundaries (time spent there counts in `ckpt_seconds`, not
        in `run_seconds`)."""
        target = steps if steps is not None else self.tcfg.total_steps
        started, saved = time.perf_counter(), self.ckpt_seconds
        while self.step < target:
            t0 = self.step
            end = self._segment_end(t0, target, eval_every, ckpt_every)
            train_loss = self._run_segment(t0, end - t0 + 1)
            if self.step % eval_every == 0 or self.step == target:
                self._record_eval(train_loss, log)
            if ckpt_path and ckpt_every and self.step % ckpt_every == 0:
                self.save_checkpoint(ckpt_path)
        self.run_seconds += (time.perf_counter() - started
                             - (self.ckpt_seconds - saved))
        return self.history

    def steps_to_ppl(self, target: float) -> Optional[int]:
        for rec in self.history:
            if rec["ppl"] <= target:
                return rec["step"]
        return None

    # ---------------------------------------------------------- checkpointing

    def trainer_state(self) -> TrainerState:
        return TrainerState(params_stack=self.params_stack,
                            opt_state=self.opt_state, engine=self.engine.state,
                            step=self.step,
                            wall_clock=float(self.engine.wall_clock),
                            data_cursor=self.step)

    def checkpoint_state(self) -> Dict[str, Any]:
        """The full-run checkpoint payload of the JAX package: TrainerState
        as plain field dicts, the host scheduler, the eval history and the
        identity meta that resume validates. Leaves are the live tensors
        (the writer copies each to the host as it reaches it)."""
        ts = self.trainer_state()
        meta = {"schema_version": META_SCHEMA_VERSION,
                "arch": self.mcfg.name, **self._traj_meta()}
        if self.spec is not None:
            meta["spec"] = self.spec.to_dict()
            meta["spec_hash"] = self.spec.spec_hash
        return {
            "format": CKPT_FORMAT,
            "trainer_state": {
                "params_stack": ts.params_stack,
                "opt_state": {"mu": ts.opt_state.mu, "nu": ts.opt_state.nu,
                              "count": ts.opt_state.count},
                "engine": es.state_to_dict(ts.engine),
                "step": ts.step,
                "wall_clock": ts.wall_clock,
                "data_cursor": ts.data_cursor,
            },
            "scheduler": self.engine.scheduler_state(),
            "history": self.history,
            "meta": meta,
        }

    def _traj_meta(self) -> Dict[str, Any]:
        """Every config knob the trajectory is a function of (data streams,
        LR schedule, protocol event schedule): saved in the checkpoint and
        checked on resume, so a mismatched resume raises instead of
        silently diverging."""
        t, c = self.tcfg, self.ccfg
        return {"method": t.method, "seed": t.seed,
                "total_steps": t.total_steps,
                "warmup_steps": t.warmup_steps, "inner_lr": t.inner_lr,
                "weight_decay": t.weight_decay, "local_batch": t.local_batch,
                "seq_len": t.seq_len, "noniid_frac": t.noniid_frac,
                "num_workers": c.num_workers, "local_steps": c.local_steps,
                "num_fragments": c.num_fragments,
                "overlap_depth": c.overlap_depth,
                "fragment_strategy": self.fragmenter.strategy,
                "routing": c.routing, "hub_failover": c.hub_failover,
                "adaptive_resync": c.adaptive_resync,
                "wire_codec": c.wire_codec, "codec_block": c.codec_block,
                "codec_error_feedback": c.codec_error_feedback,
                "channel_scheduler": c.channel_scheduler,
                "multipath_k": c.multipath_k,
                "fused_updates": c.fused_updates}

    def _upgrade_meta(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        """Upgrade checkpoint meta of any prior schema version: a key an old
        checkpoint predates implies what the code of its time did with this
        config (the JAX package's rules)."""
        meta = dict(meta)
        meta.setdefault("fragment_strategy",
                        "strided" if self.ccfg.strided_fragments
                        else "contiguous")
        meta.setdefault("routing", "static")
        meta.setdefault("hub_failover", False)
        meta.setdefault("adaptive_resync", False)
        meta.setdefault("spec", None)
        meta.setdefault("spec_hash", None)
        meta.setdefault("wire_codec", "none")
        meta.setdefault("codec_block", 256)
        meta.setdefault("codec_error_feedback", True)
        meta.setdefault("channel_scheduler", "serial")
        meta.setdefault("multipath_k", 1)
        meta.setdefault("fused_updates", False)
        meta["schema_version"] = META_SCHEMA_VERSION
        return meta

    def _validate_resume_identity(self, meta: Dict[str, Any]):
        """Reject a resume whose run identity differs from this trainer's.
        Spec-built trainers compare `spec_hash`, then the hash of the stored
        spec re-read by this code (a checkpoint written before newer spec
        fields existed); the error names the differing fields. Other
        trainers compare the trajectory meta key by key."""
        from repro_torch.api.spec import (_VOLATILE_RUN_FIELDS,
                                          ExperimentSpec, diff_specs)
        if self.spec is not None and meta["spec_hash"] is not None:
            if meta["spec_hash"] == self.spec.spec_hash:
                return
            saved = meta["spec"]
            if isinstance(saved, dict):
                try:
                    if ExperimentSpec.from_dict(saved).spec_hash == \
                            self.spec.spec_hash:
                        return
                except ValueError:
                    pass
            detail = ""
            if isinstance(saved, dict):
                try:
                    saved = ExperimentSpec.from_dict(saved).traj_dict()
                except ValueError:
                    # unknown fields (a newer writer): diff the raw dict
                    # without the labels and volatile run fields
                    saved = {k: v for k, v in saved.items()
                             if k not in ("name", "note")}
                    if isinstance(saved.get("run"), dict):
                        run = {k: v for k, v in saved["run"].items()
                               if k not in _VOLATILE_RUN_FIELDS}
                        if run.get("warmup_steps") is None and \
                                isinstance(run.get("steps"), int):
                            run["warmup_steps"] = max(10, run["steps"] // 20)
                        saved["run"] = run
                detail = "; differing fields: " + "; ".join(
                    diff_specs(saved, self.spec.traj_dict()))
            raise ValueError(
                f"checkpoint was written by a different experiment spec "
                f"(spec_hash {meta['spec_hash']} != {self.spec.spec_hash})"
                f"{detail}")
        for k, want in (("arch", self.mcfg.name), *self._traj_meta().items()):
            if meta.get(k) != want:
                raise ValueError(
                    f"checkpoint {k}={meta.get(k)!r} != trainer {want!r}: "
                    f"resume requires the saved run's config (data streams, "
                    f"LR schedule and the protocol event schedule derive "
                    f"from it)")

    def save_checkpoint(self, path: str):
        t0 = time.perf_counter()
        save_pytree(path, self.checkpoint_state())
        self.ckpt_seconds += time.perf_counter() - t0

    def restore_checkpoint(self, path: str, state: Optional[Dict] = None):
        """Restore a `checkpoint_state` dump (of either package) into this
        freshly built trainer of the same model and protocol configs; the
        run then continues exactly where the saved one stopped. Pass
        `state` if the file is already loaded."""
        st = load_pytree(path) if state is None else state
        if st.get("format") != CKPT_FORMAT:
            raise ValueError(f"not a {CKPT_FORMAT} checkpoint: {path}")
        self._validate_resume_identity(self._upgrade_meta(st["meta"]))
        ts = st["trainer_state"]
        if int(ts["data_cursor"]) != int(ts["step"]):
            raise ValueError(
                f"checkpoint data_cursor={ts['data_cursor']} != "
                f"step={ts['step']} (stateful loaders are not supported)")
        self.params_stack = restore_like(self.params_stack, ts["params_stack"])
        opt = ts["opt_state"]
        self.opt_state = AdamWState(
            mu=restore_like(self.opt_state.mu, opt["mu"]),
            nu=restore_like(self.opt_state.nu, opt["nu"]),
            count=restore_like(self.opt_state.count, opt["count"]))
        self.engine.state = es.state_from_dict(self.engine.state, ts["engine"])
        self.engine.restore_scheduler(st["scheduler"])
        # TrainerState is the single authority for the run cursors
        self.engine.wall_clock = float(ts["wall_clock"])
        self.step = int(ts["step"])
        self.history = [
            {k: (v.item() if getattr(v, "shape", None) == () else v)
             for k, v in rec.items()} for rec in st["history"]]
        return self
