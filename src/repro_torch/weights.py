"""Parameters of the JAX package -> parameters of the port.

`params_from_jax(cfg, tree)` takes the JAX package's parameter pytree as
numpy arrays (nested dicts keyed by its tree paths: ``embed``,
``layers/attn/wq``, ``layers/mlp/w_gate``, ``final_norm``, ...; the hybrid's
remainder blocks are a list, ``rem/0/mixer/wa``) and returns the port's
params. Both packages store projections as ``x @ W``, so no weight is
transposed: the port keeps JAX's orientation everywhere.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.layers import torch_dtype


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dicts and lists -> {"a/b/c": leaf}; a list item's key is its
    index (``rem/0/mixer/wa``). An empty dict or list leaves no path."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, object]):
    """{"a/b/c": leaf} -> nested dicts, a node whose keys are exactly
    0..n-1 becoming a list (the inverse of `flatten` for trees whose dicts
    have no such keys, as every param tree's)."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and sorted(out) == sorted(map(str, range(len(out)))):
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(tree)


def params_from_jax(cfg: ModelConfig, tree, device=None):
    """The JAX pytree (numpy leaves, any float dtype) -> the port's master
    params in cfg.param_dtype on `device`, in the structure of the arch's
    `param_shapes`. Raises unless the tree holds exactly the leaves and
    shapes the arch needs."""
    shapes = api.family_module(cfg).param_shapes(cfg)
    want, got = flatten(shapes), flatten(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match arch {cfg.name!r}: "
                         f"missing {missing}, unexpected {extra}")
    dtype = torch_dtype(cfg.param_dtype)

    def build(node, path):
        if isinstance(node, (dict, list)):
            items = node.items() if isinstance(node, dict) else \
                enumerate(node)
            out = {k: build(v, f"{path}/{k}" if path else str(k))
                   for k, v in items}
            return out if isinstance(node, dict) else list(out.values())
        a = np.array(got[path], dtype=np.float32)      # a writable copy
        if a.shape != tuple(node):
            raise ValueError(f"param {path}: shape {a.shape}, arch "
                             f"{cfg.name!r} needs {tuple(node)}")
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return build(shapes, "")
