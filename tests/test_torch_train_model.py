"""The port's training model and inner optimizer held against the JAX
package's, from the same params (`weights.params_from_jax`) and batches:

  * `loss_fn` and its gradients (every leaf, the norm weights included:
    the training forward takes the plain RMSNorm, so no gradient is cut)
    against JAX's `value_and_grad` at f32 compute: the loss at rtol 1e-5,
    each gradient leaf at rtol 1e-5 plus an atol of 1e-5 of the leaf's
    largest magnitude (the two frameworks sum the backward's products in
    another order; an element near zero keeps only that absolute error);
  * at bf16 compute, the loss within two bf16 ulps of its magnitude (the
    tolerance of test_torch_models.py: XLA and PyTorch round a few bf16
    products differently);
  * one worker-stacked AdamW update against the JAX update vmapped over
    the workers, rtol 1e-5; the LR schedule at rtol 1e-6.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import leaves_with_path, tree_map  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16_ULP = 2.0 ** -7


def _setup(compute, seed=0, S=32, B=2):
    jcfg = dataclasses.replace(jax_config("bench_tiny"), compute_dtype=compute)
    tcfg = dataclasses.replace(get_config("bench_tiny"), compute_dtype=compute)
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    return jcfg, tcfg, jp, tp, batch


def _grads(tcfg, tp, batch):
    leaves = [leaf.requires_grad_() for _, leaf in leaves_with_path(tp)]
    loss, metrics = api.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("S", [32, 520])        # 520: a chunk + remainder
def test_loss_and_grads_match_jax_f32(S):
    jcfg, tcfg, jp, tp, batch = _setup("float32", S=S, B=1 if S > 64 else 2)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_api.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v
                                            in batch.items()}),
        has_aux=True)(jp)
    loss, metrics, grads = _grads(tcfg, tp, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(metrics["ppl"].item(), float(jm["ppl"]),
                               rtol=1e-5)
    paths = [p for p, _ in leaves_with_path(tp)]
    for path, g, want in zip(paths, grads, jax.tree.leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)
    # the norm weights get their gradient (the plain norm keeps the graph)
    norms = [g for p, g in zip(paths, grads) if p.endswith(("ln1", "ln2",
                                                            "final_norm"))]
    assert len(norms) == 3 and all(g.abs().sum() > 0 for g in norms)


def test_loss_bf16_within_bf16_tolerance():
    jcfg, tcfg, jp, tp, batch = _setup("bfloat16")
    jl, _ = jax_api.loss_fn(jcfg, jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    loss, _, grads = _grads(tcfg, tp, batch)
    assert abs(loss.item() - float(jl)) <= 2 * BF16_ULP * abs(float(jl))
    assert all(torch.isfinite(g).all() for g in grads)


def test_adamw_update_matches_jax_vmapped():
    _, tcfg, jp, tp, _ = _setup("float32")
    M = 3
    rng = np.random.default_rng(1)
    jstack = jax.tree.map(lambda a: jnp.stack(
        [a + rng.standard_normal(a.shape).astype(np.float32) * 0.01
         for _ in range(M)]), jp)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)
        * (0.3 if a.ndim > 3 else 3.0)), jstack)   # some workers clip
    jstate = jax.vmap(jax_adamw_init)(jstack)
    tstack = tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()),
                      jstack)
    tgrads = tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()),
                      grads)
    tstate = adamw_init(tstack)
    upd = jax.vmap(lambda g, s, p, lr: jax_adamw_update(g, s, p, lr),
                   in_axes=(0, 0, 0, None))
    for step in range(2):
        lr = jax_warmup_cosine(step + 3, base_lr=3e-3, warmup_steps=5,
                               total_steps=40)
        jstack, jstate = upd(grads, jstate, jstack, lr)
        tlr = warmup_cosine(step + 3, base_lr=3e-3, warmup_steps=5,
                            total_steps=40)
        tstate = adamw_update(tgrads, tstate, tstack, tlr)
    assert tstate.count.tolist() == np.asarray(jstate.count).tolist()
    for tree_t, tree_j in ((tstack, jstack), (tstate.mu, jstate.mu),
                           (tstate.nu, jstate.nu)):
        for (path, a), b in zip(leaves_with_path(tree_t),
                                jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8, err_msg=path)


def test_warmup_cosine_matches_jax():
    steps = np.arange(0, 60)
    got = warmup_cosine(list(steps), base_lr=4e-4, warmup_steps=10,
                        total_steps=48)
    want = jax_warmup_cosine(jnp.asarray(steps), base_lr=4e-4,
                             warmup_steps=10, total_steps=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
