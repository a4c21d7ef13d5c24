"""Parameters of the JAX package -> parameters of the port.

`params_from_jax(cfg, tree)` takes the JAX package's parameter pytree as
numpy arrays (nested dicts keyed by its tree paths: ``embed``,
``layers/attn/wq``, ``layers/mlp/w_gate``, ``final_norm``, ...) and returns
the port's params. Both packages store projections as ``x @ W``, so no
weight is transposed: the port keeps JAX's orientation everywhere.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.layers import torch_dtype


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, object]):
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_jax(cfg: ModelConfig, tree, device=None):
    """The JAX pytree (numpy leaves, any float dtype) -> the port's master
    params in cfg.param_dtype on `device`. Raises unless the tree holds
    exactly the leaves and shapes the arch needs."""
    want = flatten(api.family_module(cfg).param_shapes(cfg))
    got = flatten(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match arch {cfg.name!r}: "
                         f"missing {missing}, unexpected {extra}")
    dtype = torch_dtype(cfg.param_dtype)
    out = {}
    for path, shape in want.items():
        a = np.array(got[path], dtype=np.float32)      # a writable copy
        if a.shape != tuple(shape):
            raise ValueError(f"param {path}: shape {a.shape}, arch "
                             f"{cfg.name!r} needs {tuple(shape)}")
        out[path] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return unflatten(out)
