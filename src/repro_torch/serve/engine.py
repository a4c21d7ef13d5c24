"""Continuous-batching serving engine over the slotted KV cache (counterpart
of `repro/serve/engine.py`).

One decode step runs the WHOLE slot plane every tick (`flash_decode` over
per-slot position maps); requests join and leave by flipping per-slot
registers. Prompt ingestion is CHUNKED: each admission prefills
`prefill_chunk` tokens per scheduler round, interleaved with decode steps, so
a long prompt cannot starve in-flight decodes.

Two scheduling modes share every step function:

  * ``continuous`` — admit into any free slot immediately, recycle a slot the
    tick its request completes (the serving path);
  * ``static``     — the lock-step baseline: admit a wave of up to `n_slots`
    requests, prefill them all, decode until the LAST one finishes, then
    recycle the whole wave.

Time: the engine keeps the JAX engine's VIRTUAL clock, advanced by the same
`CostModel`, so its stats (everything but ``wall_s``) equal the JAX engine's
on the same trace. ``wall_s`` is the host clock around the run.

Sampling: greedy at temperature 0. Above it, the JAX engine's draw: request
rid has the key ``fold_in(PRNGKey(seed), rid)``, and the token at sequence
position p is ``argmax(gumbel(fold_in(key, p)) + logits / temperature)``.
The threefry keys and the Gumbel noise come from `repro_torch.data.prng`
(numpy on the host, one (vocab,) draw per sampled token), so the port
samples the JAX engine's tokens.

There is no jit and so nothing to retrace; in place of the JAX engine's trace
counts, `kernel_launches()` reports the launch count of each kernel of the
serving path.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.data import prng
from repro_torch.models import api
from repro_torch.serve import cache as cache_lib

# the kernels a serving tick launches (`kernel_launches` reports these)
SERVING_KERNELS = ("flash_decode", "rms_norm")

CACHE_KEYS = ("k", "v", "kv_pos", "pos")


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. `arrival_s` is on the virtual clock; `region` is
    only meaningful when routed through a `RegionRouter`."""
    rid: int
    prompt: np.ndarray                   # (P,) int32 token ids
    max_new_tokens: int
    region: int = 0
    arrival_s: float = 0.0


@dataclasses.dataclass
class RequestRecord:
    """Per-request lifecycle trace (virtual-clock timestamps)."""
    rid: int
    region: int
    arrival_s: float
    n_prompt: int
    max_new: int
    admit_s: float = 0.0
    first_tok_s: Optional[float] = None
    done_s: Optional[float] = None
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    tok_times: List[float] = dataclasses.field(default_factory=list)
    # filled by RoutedCluster
    replica: int = -1
    req_hop_s: float = 0.0
    resp_hop_s: float = 0.0
    held_s: float = 0.0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_tok_s is None:
            return None
        return self.first_tok_s + self.resp_hop_s - self.arrival_s

    @property
    def mean_tok_latency_s(self) -> Optional[float]:
        if self.done_s is None or len(self.tokens) < 2:
            return None
        return (self.done_s - self.first_tok_s) / (len(self.tokens) - 1)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Virtual seconds charged per engine dispatch. The decode charge covers
    the FULL slot plane (the dispatch computes every slot regardless of
    occupancy — that is the physical contract of the fixed-shape step), so
    idle slots cost real time: occupancy is throughput."""
    decode_base_s: float = 0.02          # per decode dispatch
    decode_slot_s: float = 0.002         # x n_slots, occupied or not
    prefill_base_s: float = 0.01         # per prefill-chunk dispatch
    prefill_token_s: float = 0.001       # x chunk width (padded chunk computed)
    admit_s: float = 0.0005              # per admission transition

    def decode_cost(self, n_slots: int) -> float:
        return self.decode_base_s + self.decode_slot_s * n_slots

    def prefill_cost(self, chunk: int) -> float:
        return self.prefill_base_s + self.prefill_token_s * chunk


class ServeEngine:
    """Continuous-batching (or lock-step baseline) serving over one model
    replica. See module docstring for the scheduling/time model.

    params: master params (as `api.init_params` or `weights.params_from_jax`
    give them), on any device; the engine casts them once to the compute
    dtype on its own device. `impl`: "auto" = the kernels on CUDA, their
    plain versions on CPU; "ref" = the plain versions everywhere."""

    MODES = ("continuous", "static")

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8,
                 cache_len: int = 128, max_prompt: int = 64,
                 prefill_chunk: int = 16, mode: str = "continuous",
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None, impl: str = "auto",
                 cost: Optional[CostModel] = None,
                 prefill_chunks_per_tick: int = 2, device=None):
        api.family_module(cfg)          # raises for families not ported yet
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}; options: {self.MODES}")
        if impl not in ("auto", "ref"):
            raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
        self.cfg = cfg
        self.device = kernels.resolve_device(device)
        if self.device.type == "cuda":
            # f32 matmuls in full f32, as in the JAX package: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params = api.prepare_params(cfg, to_device(params, self.device))
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.max_prompt = int(max_prompt)
        self.prefill_chunk = int(prefill_chunk)
        self.mode = mode
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = eos_id
        self.impl = impl
        self.cost = cost or CostModel()
        self.prefill_chunks_per_tick = int(prefill_chunks_per_tick)
        self.window = cfg.attn_window

        self.state = cache_lib.init_slot_state(
            cfg, self.n_slots, self.cache_len, self.max_prompt,
            self.prefill_chunk, self.device)
        self.slots = cache_lib.SlotManager(self.n_slots)
        self.queue: Deque[Request] = collections.deque()
        self.records: Dict[int, RequestRecord] = {}      # rid -> record
        self.by_slot: Dict[int, RequestRecord] = {}      # occupied slot -> rec
        self.completed: List[RequestRecord] = []
        self.clock = 0.0
        self.n_decode_dispatches = 0
        self.n_prefill_dispatches = 0
        self._wave: List[int] = []                       # static mode slots

    @staticmethod
    def kernel_launches() -> Dict[str, int]:
        """Launches of each kernel of the serving path since
        `kernels.reset_launch_counts()`."""
        counts = kernels.launch_counts()
        return {k: counts[k] for k in SERVING_KERNELS}

    # ------------------------------------------------------------- sampling

    def _sample(self, logits, rids: List[int], positions: List[int]):
        """logits: (n, V) f32 -> (n,) int32 tokens; row i draws from the key
        of request rids[i] folded with its sequence position positions[i]."""
        if self.temperature <= 0.0:
            return logits.argmax(-1).to(torch.int32)
        base = prng.prng_key(self.seed)
        keys = np.stack([prng.fold_in(prng.fold_in(base, rid), p)
                         for rid, p in zip(rids, positions)])
        gumbel = torch.from_numpy(prng.gumbel(keys, (logits.shape[-1],)))
        return (gumbel.to(logits.device) + logits / self.temperature
                ).argmax(-1).to(torch.int32)

    def _eos_hit(self, toks):
        if self.eos_id is None:
            return torch.zeros_like(toks, dtype=torch.bool)
        return toks == self.eos_id

    # --------------------------------------------------------------- steps

    def _kv(self):
        return {k: self.state[k] for k in CACHE_KEYS}

    def _prefill(self, rec: RequestRecord):
        """Prefill the next chunk of `rec`'s prompt. Returns the first token
        (host int) when the chunk completes the prompt, else None."""
        st, slot = self.state, rec.slot
        start = len_prefilled(rec)
        n_valid = min(rec.n_prompt - start, self.prefill_chunk)
        chunk = st["prompt"][slot, start:start + self.prefill_chunk]
        logits, _ = api.prefill_chunk_slotted(
            self.cfg, self.params, self._kv(), chunk, slot, start, n_valid,
            window=self.window, impl=self.impl)
        st["prefilled"][slot] = start + n_valid
        rec.prefill_host = start + n_valid
        if rec.prefill_host < rec.n_prompt:
            return None
        # token at sequence position p samples stream (rid, p); the first
        # generated token sits at position plen
        tok = int(self._sample(logits[None], [rec.rid], [rec.n_prompt])[0])
        finished = rec.max_new <= 1 or (self.eos_id is not None
                                        and tok == self.eos_id)
        st["active"][slot] = not finished
        st["last_tok"][slot] = tok
        st["gen_count"][slot] = 1
        return tok

    def _decode(self):
        st = self.state
        active = st["active"].clone()
        pos0 = st["pos"].tolist() if self.temperature > 0.0 else None
        logits, _ = api.decode_step_slotted(
            self.cfg, self.params, self._kv(), st["last_tok"], active=active,
            window=self.window, impl=self.impl)
        toks = st["last_tok"].clone()
        rows = torch.nonzero(active).squeeze(1)
        if rows.numel():
            rl = rows.tolist() if pos0 is not None else []
            # the generated token's sequence position is pos0 + 1 (its input,
            # the previous token, is written at pos0), so streams never
            # collide with the first token's position plen
            toks[rows] = self._sample(logits[rows],
                                      [self.by_slot[r].rid for r in rl],
                                      [pos0[r] + 1 for r in rl])
        gen_count = st["gen_count"] + active.to(torch.int32)
        finished = active & ((gen_count >= st["gen_limit"])
                             | self._eos_hit(toks))
        st["last_tok"] = toks
        st["gen_count"] = gen_count
        st["active"] = active & ~finished
        return toks, finished

    # --------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        """Queue a request (validates it fits the slot plane)."""
        P = int(np.asarray(req.prompt).shape[0])
        if P < 1 or P > self.max_prompt:
            raise ValueError(f"prompt length {P} outside [1, {self.max_prompt}]")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.window is None and P + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request needs {P + req.max_new_tokens} cache positions > "
                f"cache_len {self.cache_len} (no sliding window to wrap into)")
        if req.rid in self.records:
            raise ValueError(f"duplicate request id {req.rid}")
        self.records[req.rid] = RequestRecord(
            rid=req.rid, region=req.region, arrival_s=req.arrival_s,
            n_prompt=P, max_new=req.max_new_tokens)
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.slots.owner)

    # ------------------------------------------------------------ scheduling

    def _admit_one(self, req: Request) -> None:
        slot = self.slots.acquire(req.rid)
        if slot is None:
            raise RuntimeError("admission with no free slot")
        rec = self.records[req.rid]
        rec.slot, rec.admit_s = slot, self.clock
        self.by_slot[slot] = rec
        P = int(np.asarray(req.prompt).shape[0])
        buf = np.zeros((self.max_prompt + self.prefill_chunk,), np.int32)
        buf[:P] = np.asarray(req.prompt, np.int32)
        cache_lib.reset_slot(self.state, slot, buf, P, int(req.max_new_tokens))
        self.clock += self.cost.admit_s

    def _prefill_one(self, rec: RequestRecord) -> None:
        t = self._prefill(rec)
        self.n_prefill_dispatches += 1
        self.clock += self.cost.prefill_cost(self.prefill_chunk)
        if t is not None:
            rec.tokens.append(t)
            rec.tok_times.append(self.clock)
            rec.first_tok_s = self.clock
            if rec.max_new <= 1 or (self.eos_id is not None
                                    and t == self.eos_id):
                self._complete(rec)

    def _decode_tick(self) -> None:
        active = [s for s, r in self.by_slot.items()
                  if r.first_tok_s is not None and r.done_s is None]
        toks, finished = self._decode()
        self.n_decode_dispatches += 1
        self.clock += self.cost.decode_cost(self.n_slots)
        self.slots.note_decode_tick(len(active))
        toks = toks.cpu().numpy()                        # host sync per tick
        finished = finished.cpu().numpy()
        for slot in active:
            rec = self.by_slot[slot]
            rec.tokens.append(int(toks[slot]))
            rec.tok_times.append(self.clock)
            if finished[slot]:
                self._complete(rec)

    def _complete(self, rec: RequestRecord) -> None:
        rec.done_s = self.clock
        self.completed.append(rec)
        if self.mode == "continuous":
            self.slots.release(rec.slot)
            del self.by_slot[rec.slot]

    def tick(self) -> None:
        """One scheduler round: admissions, prefill chunks, one decode step."""
        if self.mode == "static":
            self._tick_static()
        else:
            self._tick_continuous()

    def _tick_continuous(self) -> None:
        while self.queue and self.slots.n_free:
            self._admit_one(self.queue.popleft())
        budget = self.prefill_chunks_per_tick
        for slot in sorted(self.by_slot):
            if budget == 0:
                break
            rec = self.by_slot[slot]
            if rec.done_s is None and len_prefilled(rec) < rec.n_prompt:
                self._prefill_one(rec)
                budget -= 1
        if any(r.first_tok_s is not None and r.done_s is None
               for r in self.by_slot.values()):
            self._decode_tick()

    def _tick_static(self) -> None:
        if not self._wave and self.queue:
            # admit a wave, then prefill it COMPLETELY before any decode —
            # the lock-step baseline's head-of-line blocking, made explicit
            while self.queue and self.slots.n_free:
                self._admit_one(self.queue.popleft())
            self._wave = sorted(self.by_slot)
            for slot in self._wave:
                rec = self.by_slot[slot]
                while rec.done_s is None and len_prefilled(rec) < rec.n_prompt:
                    self._prefill_one(rec)
            return
        if any(r.done_s is None for r in self.by_slot.values()):
            self._decode_tick()
        if self._wave and all(self.by_slot[s].done_s is not None
                              for s in self._wave):
            for slot in self._wave:
                self.slots.release(slot)
                del self.by_slot[slot]
            self._wave = []

    # -------------------------------------------------------------- driving

    def run_trace(self, requests: List[Request]) -> List[RequestRecord]:
        """Feed a timed trace through the engine on the virtual clock and run
        to completion. Requests are delivered when the clock passes their
        arrival; the clock jumps over idle gaps."""
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        i = 0
        t_wall = time.perf_counter()
        while i < len(reqs) or self.has_work:
            while i < len(reqs) and reqs[i].arrival_s <= self.clock:
                self.submit(reqs[i])
                i += 1
            if not self.has_work:
                self.clock = max(self.clock, reqs[i].arrival_s)
                continue
            self.tick()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - t_wall
        return self.completed

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        """p50/p99 TTFT, per-token latency, sustained throughput, occupancy —
        all on the virtual clock (deterministic for a given trace)."""
        recs = [r for r in self.completed if r.first_tok_s is not None]
        if not recs:
            return {"completed": 0}
        ttft = np.array([r.ttft_s for r in recs])
        tok_lat = np.array([r.mean_tok_latency_s for r in recs
                            if r.mean_tok_latency_s is not None])
        total_tokens = sum(len(r.tokens) for r in recs)
        t0 = min(r.arrival_s for r in recs)
        t1 = max(r.done_s for r in recs)
        makespan = max(t1 - t0, 1e-9)
        return {
            "completed": len(recs),
            "total_tokens": total_tokens,
            "makespan_s": makespan,
            "tok_per_s": total_tokens / makespan,
            "qps": len(recs) / makespan,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "tok_latency_mean_s": float(tok_lat.mean()) if tok_lat.size else 0.0,
            "tok_latency_p99_s": (float(np.percentile(tok_lat, 99))
                                  if tok_lat.size else 0.0),
            "occupancy": self.slots.mean_occupancy,
            "decode_dispatches": self.n_decode_dispatches,
            "prefill_dispatches": self.n_prefill_dispatches,
            "wall_s": getattr(self, "wall_s", 0.0),
        }


def len_prefilled(rec: RequestRecord) -> int:
    """Host mirror of the device `prefilled` counter (no sync needed: chunk
    size and prompt length are host-known)."""
    return getattr(rec, "prefill_host", 0)
