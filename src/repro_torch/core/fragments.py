"""Model fragmentation along depth (Streaming DiLoCo / CoCoDC), the port's
copy of `repro/core/fragments.py`: the same leaf-to-fragment plans, bytes
and flat-plane layout as the JAX package for the same shapes.

Layer-stacked leaves (leading axis == a known layer count) are split by
layer rows under a ``strategy``: "strided" (layer l -> fragment l % K),
"contiguous" (equal consecutive blocks) or "skewed" (geometric byte shares
∝ SKEW_RATIO**p, >= 1 layer each). Non-stacked leaves (embeddings, heads,
norms) go wholesale to the (weight-relative) lightest fragment, biggest
first. Leaves are visited in JAX's pytree order (`tree.leaves_with_path`),
which decides the greedy assignment's ties and the flat plane's offsets.

`extract` gathers a fragment's rows into new tensors (a whole leaf is
returned as is, not copied); `insert` writes a fragment back IN PLACE into
the tree's tensors (the JAX version returns a new tree) and returns the
tree: the engine's buffers are the largest tensors of a run, and nothing
reads their old values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import (ShapeDtype, leaves_with_path, specs_of,
                                   tree_map_with_path)


@dataclasses.dataclass(frozen=True)
class _LeafPlan:
    path: str
    is_layered: bool
    # layered: rows[p] = tuple of layer indices for fragment p
    rows: Tuple[Tuple[int, ...], ...] | None
    # non-layered: owning fragment
    owner: int | None
    nbytes_per_row: int
    nbytes: int


def _as_spec(leaf) -> ShapeDtype:
    if isinstance(leaf, ShapeDtype):
        return leaf
    return ShapeDtype(tuple(leaf.shape), leaf.dtype)


class Fragmenter:
    STRATEGIES = ("strided", "contiguous", "skewed")
    SKEW_RATIO = 0.55      # geometric byte share of fragment p ∝ SKEW_RATIO**p

    def __init__(self, params_shape: Any, n_fragments: int,
                 layer_counts: Sequence[int], *, strided: bool = True,
                 strategy: str = ""):
        """params_shape: tree of `ShapeDtype` (or tensors, read for their
        shapes only). layer_counts: leading-dim sizes that mark a leaf as
        layer-stacked. `strategy` overrides `strided` when non-empty."""
        self.K = int(n_fragments)
        if not strategy:
            strategy = "strided" if strided else "contiguous"
        if strategy not in self.STRATEGIES:
            raise ValueError(f"unknown fragment strategy {strategy!r}; "
                             f"options: {self.STRATEGIES}")
        self.strategy = strategy
        weights = (np.array([self.SKEW_RATIO ** p for p in range(self.K)])
                   if strategy == "skewed" else np.ones(self.K))
        counts = {int(c) for c in layer_counts if int(c) > 1}
        specs = [(p, _as_spec(leaf))
                 for p, leaf in leaves_with_path(params_shape)]
        plans: List[_LeafPlan] = []
        frag_bytes = np.zeros(self.K, dtype=np.int64)

        # pass 1: layered leaves
        pending_flat = []
        for p, leaf in specs:
            nbytes = (int(np.prod(leaf.shape)) * leaf.itemsize if leaf.shape
                      else leaf.itemsize)
            layered = (len(leaf.shape) >= 2 and leaf.shape[0] in counts
                       and p.split("/")[0] in ("layers", "encoder", "decoder",
                                               "rem", "groups"))
            if layered:
                L = leaf.shape[0]
                rows = self._layer_rows(L)
                per_row = nbytes // L
                for f in range(self.K):
                    frag_bytes[f] += per_row * len(rows[f])
                plans.append(_LeafPlan(p, True, rows, None, per_row, nbytes))
            else:
                pending_flat.append((p, nbytes))

        # pass 2: whole leaves, biggest first (stable: ties keep pytree
        # order), to the (weight-relative) lightest fragment
        for p, nbytes in sorted(pending_flat, key=lambda t: -t[1]):
            owner = int(np.argmin(frag_bytes / weights))
            frag_bytes[owner] += nbytes
            plans.append(_LeafPlan(p, False, None, owner, nbytes, nbytes))

        self._plans: Dict[str, _LeafPlan] = {pl.path: pl for pl in plans}
        self._frag_bytes = frag_bytes
        from repro_torch.core.flatplane import FlatView
        self.flat = FlatView(specs, self._plans, self.K)

    def _layer_rows(self, L: int) -> Tuple[Tuple[int, ...], ...]:
        """Per-fragment layer indices for an L-deep stacked leaf."""
        K = self.K
        if self.strategy == "strided":
            rows = [[] for _ in range(K)]
            for l in range(L):
                rows[l % K].append(l)
        elif self.strategy == "contiguous":
            rows = [[] for _ in range(K)]
            for l in range(L):
                rows[min(l * K // L, K - 1)].append(l)
        else:  # skewed: geometric consecutive block sizes, >=1 layer each
            if L < K:
                sizes = [1 if p < L else 0 for p in range(K)]
            else:
                w = np.array([self.SKEW_RATIO ** p for p in range(K)])
                extra = (L - K) * w / w.sum()
                base = np.floor(extra).astype(int)
                order = sorted(range(K),
                               key=lambda p: (-(extra[p] - base[p]), p))
                for p in order[:int(L - K - base.sum())]:
                    base[p] += 1
                sizes = [1 + int(b) for b in base]
            rows, off = [], 0
            for s in sizes:
                rows.append(list(range(off, off + s)))
                off += s
        return tuple(tuple(r) for r in rows)

    # -- interface ----------------------------------------------------------

    def fragment_bytes(self, p: int) -> int:
        return int(self._frag_bytes[p])

    @property
    def total_bytes(self) -> int:
        return int(self._frag_bytes.sum())

    def leaves_in(self, p: int) -> List[str]:
        """Paths of the leaves with elements in fragment p."""
        return [c.path for c in self.flat.chunks(p)]

    def extract(self, tree, p: int, *, worker_axis: bool = False):
        """The fragment-p sub-tree (same structure; absent leaves -> None,
        layered leaves -> a new tensor of the fragment's rows). worker_axis:
        leaves have a leading worker dim M before the layer axis."""
        off = 1 if worker_axis else 0

        def fn(path, leaf):
            plan = self._plans[path]
            if plan.is_layered:
                rows = plan.rows[p]
                if not rows:
                    return None
                idx = torch.tensor(rows, device=leaf.device)
                return leaf.index_select(off, idx)
            return leaf if plan.owner == p else None

        return tree_map_with_path(fn, tree)

    def insert(self, tree, p: int, frag, *, worker_axis: bool = False):
        """Write fragment-p values back into the tree's tensors, in place;
        returns the tree."""
        off = 1 if worker_axis else 0

        def fn(path, leaf, fleaf):
            plan = self._plans[path]
            if plan.is_layered:
                rows = plan.rows[p]
                if rows and fleaf is not None:
                    idx = torch.tensor(rows, device=leaf.device)
                    leaf.index_copy_(off, idx, fleaf.to(leaf.dtype))
                return leaf
            if plan.owner == p:
                if fleaf is None:
                    raise ValueError(f"missing fragment leaf for {path}")
                if fleaf is not leaf:
                    leaf.copy_(fleaf)
            return leaf

        return tree_map_with_path(fn, tree, frag)

    def owners(self) -> Dict[str, Any]:
        """path -> (fragment owner | per-fragment rows)."""
        return {p: (pl.rows if pl.is_layered else pl.owner)
                for p, pl in self._plans.items()}


def make_fragmenter(cfg_model, params_shape, n_fragments: int, *,
                    strided: bool = True, strategy: str = "") -> Fragmenter:
    counts = [cfg_model.n_layers, cfg_model.n_enc_layers]
    if cfg_model.block_pattern:
        counts.append(cfg_model.n_layers // len(cfg_model.block_pattern))
    if not isinstance(next(iter(leaves_with_path(params_shape)))[1],
                      ShapeDtype):
        params_shape = specs_of(params_shape)
    return Fragmenter(params_shape, n_fragments, counts, strided=strided,
                      strategy=strategy)
