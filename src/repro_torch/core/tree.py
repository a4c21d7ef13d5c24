"""Parameter trees of the port: nested dicts of tensors (or None for a leaf
absent from a fragment), walked in the JAX package's pytree order.

JAX flattens a dict in SORTED key order, the port's dicts keep insertion
order; the fragment plan (greedy whole-leaf assignment) and the flat plane's
offsets both depend on the walk order, so every walk over a param tree in
the engine goes through `leaves_with_path`, which sorts keys at every level
and names a leaf by its ``a/b/c`` path as the JAX package's `_path_str`
does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Abstract leaf (the port's `jax.ShapeDtypeStruct`)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flatten order (sorted dict keys, depth
    first). None leaves are kept."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(leaves_with_path(v, path))
        else:
            out.append((path, v))
    return out


def tree_map(fn: Callable, tree, *rest):
    """Map `fn` over the leaves of `tree` (and the matching leaves of
    `rest`), keeping the structure; None leaves of `tree` stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """`tree_map` whose `fn` also receives the leaf's ``a/b/c`` path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(
                    fn, v, *(r[k] for r in rest),
                    prefix=f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def specs_of(tree):
    """Tensor tree -> ShapeDtype tree (metadata only)."""
    return tree_map(lambda a: ShapeDtype(tuple(a.shape), a.dtype), tree)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree) if leaf is not None]
