"""The port's protocol-engine transitions held against the JAX package's:
`initiate`, `deliver` and `diloco_round`, per leaf and on the fused flat
plane, for every registered method, with an offline worker, bf16 sync
payloads and top-k sparsification, from the same params and the same
perturbations. Tolerance: rtol 1e-5 (the JAX package's own kernel-vs-oracle
pin); the schedule fields (in-flight flags, t_init, last_sync) identical.

The port's fused path runs the kernels' plain versions on the CPU; a spy
also checks that every operand the engine hands them has the layout the
CUDA kernels take (contiguous planes, a strided worker axis at most).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import CoCoDCConfig as JaxCCfg  # noqa: E402
from repro.core import engine_state as jes  # noqa: E402
from repro.core.fragments import make_fragmenter as jax_fragmenter  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import CoCoDCConfig  # noqa: E402
from repro_torch.core import engine_state as es  # noqa: E402
from repro_torch.core.fragments import make_fragmenter  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels.outer_update import ops as ou_ops  # noqa: E402
from repro_torch.kernels.outer_update import outer_update as ou_cuda  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M = 3
EVENTS = [("init", 0, 1), ("init", 2, 3), ("deliver", 4, 1),
          ("init", 5, 0), ("deliver", 6, 3), ("deliver", 9, 0),
          ("round", 11, None)]
CASES = {"plain": {}, "offline": {"offline": 1},
         "bf16": {"sync_dtype": "bfloat16"},
         "topk": {"sync_topk_frac": 0.3}}


def _leaves(x):
    """Leaves in pytree order (the port walks dicts in JAX's sorted-key
    order) as numpy."""
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(a) for a in jax.tree.leaves(
        x, is_leaf=lambda a: isinstance(a, torch.Tensor))]


def _close(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=what)


@pytest.fixture
def layout_spy(monkeypatch):
    """Check every fused-kernel operand's layout, then run the plain
    version."""
    nest, dlv = ou_ops.nesterov_ref, ou_ops.deliver_ref

    def nesterov(theta, momentum, delta, **kw):
        ou_cuda.check_nesterov_operands(theta, momentum, delta)
        return nest(theta, momentum, delta, **kw)

    def deliver(local, snapshot, g, avail, *, mode, **kw):
        ou_cuda.check_deliver_operands(local, snapshot, g,
                                       avail.to(torch.float32), mode)
        return dlv(local, snapshot, g, avail, mode=mode, **kw)

    monkeypatch.setattr(ou_ops, "nesterov_ref", nesterov)
    monkeypatch.setattr(ou_ops, "deliver_ref", deliver)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", ["cocodc", "streaming", "diloco",
                                    "local"])
def test_transitions_match_jax(method, fused, case, layout_spy):
    opts = dict(CASES[case])
    offline = opts.pop("offline", None)
    kw = dict(num_workers=M, local_steps=12, num_fragments=4,
              overlap_depth=3, fused_updates=fused, mixing_alpha=0.6,
              comp_lambda=0.4, **opts)
    jcfg, tcfg = jax_config("bench_tiny"), get_config("bench_tiny")
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jstack = jax.tree.map(lambda a: jax.numpy.stack([a] * M), jp)
    tstack = tree_map(lambda a: a[None].repeat((M,) + (1,) * a.dim()), tp)
    jfrag = jax_fragmenter(jcfg, jax.eval_shape(lambda: jp), 4)
    tfrag = make_fragmenter(tcfg, api.param_specs(tcfg), 4)
    jst = jes.init_state(method, JaxCCfg(**kw), jstack, frag=jfrag)
    tst = es.init_state(method, CoCoDCConfig(**kw), tstack, frag=tfrag)
    jfn = jes.make_engine_fns(method, JaxCCfg(**kw), jfrag, use_jit=False)
    tfn = es.make_engine_fns(method, CoCoDCConfig(**kw), tfrag)
    if offline is not None:
        jst = dataclasses.replace(
            jst, worker_available=jst.worker_available.at[offline].set(False))
        tst.worker_available[offline] = False
    rng = np.random.default_rng(0)
    overlapped = method in ("cocodc", "streaming")
    for kind, t, p in EVENTS:
        noise = [(rng.standard_normal(a.shape) * 1e-2).astype(np.float32)
                 for a in jax.tree.leaves(jstack)]
        it = iter(noise)
        jstack = jax.tree.map(lambda a: a + next(it), jstack)
        for leaf, n in zip(tree_leaves(tstack), noise):
            leaf.add_(torch.from_numpy(n))
        if kind == "round":
            if method != "diloco":
                continue
            jst, jstack = jfn.diloco_round(jst, jstack)
            tst, tstack = tfn.diloco_round(tst, tstack)
        elif not overlapped:
            continue
        elif kind == "init":
            jst = jfn.initiate(jst, t, jstack, p)
            tst = tfn.initiate(tst, t, tstack, p)
        else:
            jst, jstack = jfn.deliver(jst, t, jstack, p)
            tst, tstack = tfn.deliver(tst, t, tstack, p)
        what = f"{kind} t={t} p={p}"
        _close(tstack, jstack, f"params after {what}")
        for f in ("theta_g", "momentum", "inflight_delta",
                  "inflight_snapshot", "delta_norm", "rate"):
            a, b = getattr(tst, f), getattr(jst, f)
            assert (a is None) == (b is None), f
            if a is not None:
                _close(a, b, f"{f} after {what}")
        for f in ("inflight_active", "inflight_t_init", "last_sync",
                  "worker_available"):
            assert np.array_equal(getattr(tst, f).numpy(),
                                  np.asarray(getattr(jst, f))), f
