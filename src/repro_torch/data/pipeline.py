"""Deterministic synthetic non-IID LM data pipeline of the port (counterpart
of `repro/data/pipeline.py`): the same per-worker sparse Zipfian Markov
chains and the same tokens.

Each worker draws from its own successor table (a shared backbone with a
fraction of rows rewired per worker); a batch is a pure function of
(worker, step). The JAX package draws the chain with threefry on the device;
the port draws the same numbers on the host with `repro_torch.data.prng`
(numpy uint32), so both packages see one corpus: `randint` and the key
splits are bit-exact, and the Gumbel-max choice goes through a float32
``log`` that may differ from XLA's in the last ulp (see `prng`). Batches are
numpy int32 arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.data import prng


def _gen_batch(succ: np.ndarray, log_w: np.ndarray, seed: int, step: int,
               batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
    """One (B, S) batch as a pure function of (seed, step): the JAX
    package's `_gen_batch`, with its scan over S+1 positions written out."""
    key = prng.fold_in(prng.prng_key(seed), step)
    k0, k1 = prng.split(key, 2)
    state = prng.randint(k0, (batch_size,), 0, succ.shape[0])
    choice_keys = prng.split(k1, seq_len + 1)              # (S+1, 2)
    idx = prng.categorical(choice_keys, log_w, batch_size)  # (S+1, B)
    toks = np.empty((batch_size, seq_len + 1), np.int32)
    for s in range(seq_len + 1):
        state = succ[state, idx[s]]
        toks[:, s] = state
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class MarkovCorpus:
    vocab: int
    branch: int = 8             # successors per token
    seed: int = 0
    worker_id: int = 0
    noniid_frac: float = 0.25   # fraction of rows rewired per worker

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        V, Br = self.vocab, self.branch
        # global backbone: successor table (V, Br) + Zipf weights
        self.succ = rng.randint(0, V, size=(V, Br)).astype(np.int32)
        if self.noniid_frac > 0 and self.worker_id >= 0:
            wrng = np.random.RandomState(self.seed + 7919 * (self.worker_id + 1))
            n_rewire = int(V * self.noniid_frac)
            rows = wrng.choice(V, size=n_rewire, replace=False)
            self.succ[rows] = wrng.randint(0, V, size=(n_rewire, Br))
        w = 1.0 / np.arange(1, Br + 1) ** 1.2
        weights = (w / w.sum()).astype(np.float32)
        self.log_w = np.log(weights.astype(np.float64)).astype(np.float32)

    @property
    def _seed32(self) -> int:
        return (self.seed * 1_000_003 + self.worker_id) % (1 << 31)

    def batch(self, step: int, batch_size: int, seq_len: int):
        """Pure function of (worker, step): {tokens, labels} (B, S) int32."""
        return _gen_batch(self.succ, self.log_w, self._seed32, step,
                          batch_size, seq_len)

    def segment(self, t0: int, n: int, batch_size: int, seq_len: int):
        """`n` consecutive batches stacked: {tokens, labels} (n, B, S);
        segment(t0, n)[i] == batch(t0 + i)."""
        bs = [self.batch(t0 + i, batch_size, seq_len) for i in range(n)]
        return {k: np.stack([b[k] for b in bs]) for k in ("tokens", "labels")}


def make_worker_streams(num_workers: int, vocab: int, *, seed: int = 0,
                        noniid_frac: float = 0.25) -> List[MarkovCorpus]:
    """One non-IID corpus per worker/datacenter."""
    return [MarkovCorpus(vocab=vocab, seed=seed, worker_id=m,
                         noniid_frac=noniid_frac) for m in range(num_workers)]


def stacked_batch(streams, step: int, batch_size: int, seq_len: int):
    """Worker-stacked batch: leaves (M, B, S)."""
    bs = [s.batch(step, batch_size, seq_len) for s in streams]
    return {k: np.stack([b[k] for b in bs]) for k in ("tokens", "labels")}


def stacked_segment(streams, t0: int, n: int, batch_size: int, seq_len: int):
    """Step-major segment: leaves (n, M, B, S); equals stacking
    `stacked_batch(streams, t0 + i)` over i."""
    segs = [s.segment(t0, n, batch_size, seq_len) for s in streams]
    return {k: np.stack([g[k] for g in segs], axis=1)
            for k in ("tokens", "labels")}
