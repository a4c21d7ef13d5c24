"""Flat fragment plane of the port (counterpart of `repro/core/flatplane.py`):
one contiguous ``(rows, LANES)`` f32 buffer per fragment with static
per-leaf offsets, the same layout as the JAX package's.

  * fragment-major: fragment p owns the row span
    ``[row_start(p), row_start(p) + rows(p))`` of a ``(total_rows, LANES)``
    full-model buffer, so full-model engine buffers are addressed by static
    row slices (views, no copies);
  * within a fragment: per-leaf chunks in JAX pytree order at static
    element offsets (layered leaves contribute their fragment rows, whole
    leaves their full extent), zero-padded to a LANES multiple at the
    fragment END only.

`pack` gathers a tree's fragment into a new buffer; `unpack` writes a
buffer back into the tree's tensors IN PLACE (the JAX version returns a
new tree) and returns the tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_path

LANES = 1024            # the TPU kernels' (8, 128) f32 tile, flattened


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@dataclasses.dataclass(frozen=True)
class _Chunk:
    """One leaf's contribution to one fragment's flat buffer."""
    path: str
    offset: int                       # element offset inside the fragment
    size: int                         # element count
    rows: Tuple[int, ...] | None      # layered: layer indices; None = whole
    shape: Tuple[int, ...]            # unraveled chunk shape (rows-first)


class FlatView:
    """Static flat layout of a fragmented model. Built by
    `Fragmenter.__init__` from its leaf plans; exposed as
    ``Fragmenter.flat``."""

    LANES = LANES

    def __init__(self, specs: List[Tuple[str, Any]], plans: Dict[str, Any],
                 K: int) -> None:
        self.K = int(K)
        self._chunks: List[List[_Chunk]] = []
        self._elems: List[int] = []          # payload elements per fragment
        self._rows: List[int] = []           # padded rows per fragment
        for p in range(self.K):
            chunks: List[_Chunk] = []
            off = 0
            for key, leaf in specs:
                plan = plans[key]
                if plan.is_layered:
                    rows = plan.rows[p]
                    if not rows:
                        continue
                    shape = (len(rows),) + tuple(int(d)
                                                 for d in leaf.shape[1:])
                    chunks.append(_Chunk(key, off, _prod(shape), tuple(rows),
                                         shape))
                elif plan.owner == p:
                    shape = tuple(int(d) for d in leaf.shape)
                    chunks.append(_Chunk(key, off, _prod(shape), None, shape))
                else:
                    continue
                off += chunks[-1].size
            self._chunks.append(chunks)
            self._elems.append(off)
            self._rows.append(-(-off // LANES))
        starts = np.cumsum([0] + self._rows)
        self._row_start: List[int] = [int(s) for s in starts[:-1]]
        self.total_rows: int = int(starts[-1])

    # ------------------------------------------------------------ geometry

    def chunks(self, p: int) -> List[_Chunk]:
        return list(self._chunks[p])

    def rows(self, p: int) -> int:
        """Padded (rows, LANES) row count of fragment p's buffer."""
        return self._rows[p]

    def elems(self, p: int) -> int:
        """Payload elements of fragment p (excludes trailing pad)."""
        return self._elems[p]

    def row_span(self, p: int) -> Tuple[int, int]:
        """Fragment p's ``[start, stop)`` row span in the full-model plane."""
        return self._row_start[p], self._row_start[p] + self._rows[p]

    def full_zeros(self, *lead, device=None) -> torch.Tensor:
        """A zeroed full-model plane, optional leading dims (e.g. the worker
        axis for the CoCoDC snapshot)."""
        return torch.zeros(tuple(lead) + (self.total_rows, LANES),
                           dtype=torch.float32, device=device)

    # ---------------------------------------------------------------- pack

    def pack(self, tree, p: int, *, worker_axis: bool = False) -> torch.Tensor:
        """Ravel fragment p's elements of `tree` into one new f32 buffer:
        ``(rows(p), LANES)``, or ``(M, rows(p), LANES)`` with a leading
        worker axis. Trailing pad is zero."""
        by_path = dict(leaves_with_path(tree))
        first = next(iter(by_path.values()))
        lead: Tuple[int, ...] = (first.shape[0],) if worker_axis else ()
        out = torch.zeros(lead + (self._rows[p] * LANES,),
                          dtype=torch.float32, device=first.device)
        for ch in self._chunks[p]:
            leaf = by_path[ch.path]
            if ch.rows is not None:
                idx = torch.tensor(ch.rows, device=leaf.device)
                leaf = leaf.index_select(1 if worker_axis else 0, idx)
            out[..., ch.offset:ch.offset + ch.size] = leaf.reshape(lead + (-1,))
        return out.reshape(lead + (self._rows[p], LANES))

    def pack_stack(self, stack, p: int) -> torch.Tensor:
        """`pack` with a leading worker axis: ``(M, rows(p), LANES)``."""
        return self.pack(stack, p, worker_axis=True)

    def pack_full(self, tree, *, worker_axis: bool = False) -> torch.Tensor:
        """Full-model plane: every fragment's buffer stacked along the row
        axis in fragment order — ``(total_rows, LANES)``."""
        bufs = [self.pack(tree, p, worker_axis=worker_axis)
                for p in range(self.K)]
        return torch.cat(bufs, dim=1 if worker_axis else 0)

    # -------------------------------------------------------------- unpack

    def unpack(self, tree, p: int, buf, *, worker_axis: bool = False):
        """Write fragment p's flat buffer back into `tree` in place (static
        slices + row scatters; leaves absent from p are untouched), cast to
        each leaf's dtype. Returns the tree."""
        lead = tuple(buf.shape[:-2])
        flat = buf.reshape(lead + (-1,))
        by_path = dict(leaves_with_path(tree))
        for ch in self._chunks[p]:
            leaf = by_path[ch.path]
            x = flat[..., ch.offset:ch.offset + ch.size].reshape(
                lead + ch.shape).to(leaf.dtype)
            if ch.rows is None:
                leaf.copy_(x)
            else:
                idx = torch.tensor(ch.rows, device=leaf.device)
                leaf.index_copy_(1 if worker_axis else 0, idx, x)
        return tree

    def unpack_stack(self, stack, p: int, buf):
        """`unpack` with a leading worker axis."""
        return self.unpack(stack, p, buf, worker_axis=True)

    def unpack_full(self, tree, buf, *, worker_axis: bool = False):
        """Inverse of `pack_full`: write the whole plane back into `tree`."""
        for p in range(self.K):
            r0, r1 = self.row_span(p)
            frag = buf[:, r0:r1] if worker_axis else buf[r0:r1]
            self.unpack(tree, p, frag, worker_axis=worker_axis)
        return tree
