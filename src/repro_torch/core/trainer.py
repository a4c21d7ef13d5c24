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
weights. Checkpointing is not ported yet (ROADMAP.md, Queue A:
'checkpoint writing and resume').
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import CoCoDCConfig, ModelConfig
from repro_torch.core.fragments import make_fragmenter
from repro_torch.core.network import NetworkModel, Topology, paper_network
from repro_torch.core.protocol import NETWORK_TODO, ProtocolEngine
from repro_torch.core.tree import leaves_with_path, tree_map
from repro_torch.data.pipeline import (MarkovCorpus, make_worker_streams,
                                       stacked_segment)
from repro_torch.kernels import resolve_device
from repro_torch.models import api
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
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


class CrossRegionTrainer:
    def __init__(self, model_cfg: ModelConfig, ccfg: CoCoDCConfig,
                 tcfg: TrainerConfig,
                 network: Optional["NetworkModel | Topology"] = None,
                 dynamics: Optional[str] = None, dynamics_seed: int = 0,
                 spec: Optional[Any] = None, *, device=None, params=None,
                 **engine_kw):
        """`engine_kw` (`dc_impl`, `fused_impl`) passes to the
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

    def _segment_end(self, t: int, target: int, eval_every: int) -> int:
        """Last step (inclusive) of the segment starting at t: the earliest
        of the next protocol event, the next eval boundary, and the end
        (`t` itself under `loop="per_step"`)."""
        if self.tcfg.loop == "per_step":
            return t
        end = min(target - 1, t + self.tcfg.max_segment - 1)
        ne = self.engine.next_event_step(t)
        if ne is not None:
            end = min(end, ne)
        if eval_every:
            end = min(end, (t // eval_every + 1) * eval_every - 1)
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
            log: Callable[[str], None] = lambda s: None):
        """Train to absolute step `steps` (default tcfg.total_steps),
        recording an eval every `eval_every` steps and at the end."""
        target = steps if steps is not None else self.tcfg.total_steps
        started = time.perf_counter()
        while self.step < target:
            t0 = self.step
            end = self._segment_end(t0, target, eval_every)
            train_loss = self._run_segment(t0, end - t0 + 1)
            if self.step % eval_every == 0 or self.step == target:
                self._record_eval(train_loss, log)
        self.run_seconds += time.perf_counter() - started
        return self.history

    def steps_to_ppl(self, target: float) -> Optional[int]:
        for rec in self.history:
            if rec["ppl"] <= target:
                return rec["step"]
        return None

