"""The plain versions of the port's outer-update and delay-compensation
kernels held against the JAX package's oracles and its Pallas kernels
(interpret mode), on the same numpy inputs, at rtol 1e-5 (the JAX
package's own kernel-vs-oracle pin); plus the wrappers' refusals: the
launchers never take CPU tensors, and "auto" never lets a gradient through
a kernel without a backward.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.delay_comp.ops import delay_comp_array as jax_dc_array  # noqa: E402
from repro.kernels.delay_comp.ref import delay_comp_ref as jax_dc_ref  # noqa: E402
from repro.kernels.outer_update.ops import fused_deliver as jax_deliver  # noqa: E402
from repro.kernels.outer_update.ops import outer_nesterov as jax_nesterov  # noqa: E402
from repro.kernels.outer_update.ref import deliver_ref as jax_deliver_ref  # noqa: E402
from repro.kernels.outer_update.ref import nesterov_ref as jax_nesterov_ref  # noqa: E402
from repro_torch.kernels.delay_comp.delay_comp import delay_comp_cuda  # noqa: E402
from repro_torch.kernels.delay_comp.ops import delay_comp, delay_comp_array  # noqa: E402
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.kernels.outer_update.ops import (fused_deliver,  # noqa: E402
                                                  outer_nesterov)
from repro_torch.kernels.outer_update import outer_update as ou_cuda  # noqa: E402
from repro_torch.kernels.outer_update.outer_update import (deliver_cuda,  # noqa: E402
                                                           nesterov_cuda)
from repro_torch.kernels.rms_norm.ops import rms_norm  # noqa: E402
from test_torch_kernels_cuda import (COMP_KW, assert_term_dominates,  # noqa: E402,F401
                                     one_torch_thread, outer_case)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor)
                               else np.asarray(got),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows", [1, 37, 300])     # 300: not a 256 multiple
def test_nesterov_plain_matches_jax(rows):
    c = outer_case(rows, m=1, seed=rows)
    args = (c["theta"], c["mom"], c["delta"])
    t, m = outer_nesterov(*map(torch.from_numpy, args), lr=0.7, mu=0.9)
    for want in (jax_nesterov_ref(*map(jnp.asarray, args), lr=0.7, mu=0.9),
                 jax_nesterov(*map(jnp.asarray, args), lr=0.7, mu=0.9,
                              impl="pallas")):
        _close(t, want[0])
        _close(m, want[1])


@pytest.mark.parametrize("mode", ["blend", "compensate"])
@pytest.mark.parametrize("rows", [3, 300])
def test_deliver_plain_matches_jax_with_offline_worker(mode, rows):
    c = outer_case(rows, m=3, seed=7)
    avail = np.array([True, False, True])
    kw = ({"alpha": 0.3} if mode == "blend"
          else {"tau": 7.0, "lam": 0.5, "H": 24.0, "sign": -1.0})
    snap = c["snap"] if mode == "compensate" else None
    got = fused_deliver(torch.from_numpy(c["local"]),
                        None if snap is None else torch.from_numpy(snap),
                        torch.from_numpy(c["g"]), torch.from_numpy(avail),
                        mode=mode, **kw)
    jargs = (jnp.asarray(c["local"]),
             None if snap is None else jnp.asarray(snap),
             jnp.asarray(c["g"]), jnp.asarray(avail))
    _close(got, jax_deliver_ref(*jargs, mode=mode, **kw))
    _close(got, jax_deliver(*jargs, mode=mode, impl="pallas", **kw))
    assert torch.equal(got[1], torch.from_numpy(c["local"][1]))


def test_deliver_takes_a_device_tau():
    """The engine hands tau as a 0-d tensor (no host sync); the result
    equals the python-float form."""
    c = outer_case(5, m=2, seed=3)
    args = [torch.from_numpy(c[k]) for k in ("local", "snap", "g")]
    avail = torch.ones(2, dtype=torch.bool)
    a = fused_deliver(*args, avail, mode="compensate", tau=torch.tensor(6.0),
                      lam=0.5, H=24.0)
    b = fused_deliver(*args, avail, mode="compensate", tau=6.0, lam=0.5,
                      H=24.0)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape,bcast", [((4, 3, 96), True),
                                         ((2, 5, 33), False),
                                         ((3, 1024), True)])
def test_delay_comp_plain_matches_jax(shape, bcast):
    rng = np.random.default_rng(len(shape) + shape[-1])
    tp = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    tl = tp + (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    gshape = (1,) + shape[1:] if bcast else shape
    tg = tp[:1] if bcast else tp
    tg = (tg + rng.standard_normal(gshape) * 1e-3).astype(np.float32)
    kw = dict(tau=8.0, lam=0.5, H=24.0, sign=1.0)
    got = delay_comp_array(*map(torch.from_numpy, (tl, tp, tg)), **kw)
    assert got.shape == shape
    j = tuple(map(jnp.asarray, (tl, tp, tg)))
    _close(got, jax_dc_ref(*j, **kw))
    _close(got, jax_dc_array(*j, impl="pallas", **kw))
    # the tree form: None leaves pass through
    tree = delay_comp({"a": torch.from_numpy(tl), "b": None},
                      {"a": torch.from_numpy(tp), "b": None},
                      {"a": torch.from_numpy(tg), "b": None}, **kw)
    assert tree["b"] is None and torch.equal(tree["a"], got)


@pytest.mark.parametrize("rows", [3, 300])
def test_deliver_compensation_term_matches_jax(rows):
    """Operands O(1) apart and COMP_KW's scalars, where Algorithm 1's Taylor
    term dominates the tolerance; one worker offline."""
    c = outer_case(rows, m=3, seed=11 + rows, spread=1.0)
    avail = np.array([True, True, False])
    args = [torch.from_numpy(c[k]) for k in ("local", "snap", "g")]
    got = fused_deliver(*args, torch.from_numpy(avail), mode="compensate",
                        **COMP_KW)
    assert_term_dominates(got[:2], fused_deliver(
        *args, torch.from_numpy(avail), mode="compensate",
        **{**COMP_KW, "lam": 0.0})[:2])
    jargs = [jnp.asarray(c[k]) for k in ("local", "snap", "g")]
    jargs.append(jnp.asarray(avail))
    _close(got, jax_deliver_ref(*jargs, mode="compensate", **COMP_KW))
    _close(got, jax_deliver(*jargs, mode="compensate", impl="pallas",
                            **COMP_KW))
    assert torch.equal(got[2], args[0][2])


@pytest.mark.parametrize("shape,bcast", [((4, 3, 96), True),
                                         ((2, 5, 36), False)])
def test_delay_comp_compensation_term_matches_jax(shape, bcast):
    rng = np.random.default_rng(shape[-1])
    tp = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    tl = tp + rng.standard_normal(shape).astype(np.float32)
    gshape = (1,) + shape[1:] if bcast else shape
    tg = ((tp[:1] if bcast else tp)
          + rng.standard_normal(gshape)).astype(np.float32)
    t = tuple(map(torch.from_numpy, (tl, tp, tg)))
    got = delay_comp_array(*t, **COMP_KW)
    assert_term_dominates(got, delay_comp_array(*t, **{**COMP_KW,
                                                       "lam": 0.0}))
    j = tuple(map(jnp.asarray, (tl, tp, tg)))
    _close(got, jax_dc_ref(*j, **COMP_KW))
    _close(got, jax_dc_array(*j, impl="pallas", **COMP_KW))


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros(2, 1024)
    s2, s4, s5 = torch.zeros(2), torch.zeros(4), torch.zeros(5)
    with pytest.raises(ValueError, match="CUDA"):
        nesterov_cuda(x, x, x, s2)
    with pytest.raises(ValueError, match="CUDA"):
        deliver_cuda(x[None], None, x, torch.ones(1), s5, mode="blend")
    with pytest.raises(ValueError, match="CUDA"):
        delay_comp_cuda(x[None], x[None], x[None], s4)
    with pytest.raises(ValueError, match="multiple of 4"):
        odd = torch.zeros(2, 3, 97)
        delay_comp_cuda(odd, odd, odd[:1], s4)
    with pytest.raises(ValueError, match="rows"):
        ou_cuda.check_nesterov_operands(torch.zeros(2, 100), x, x)
    with pytest.raises(ValueError, match="snapshot"):
        ou_cuda.check_deliver_operands(x[None], None, x, torch.ones(1),
                                       "compensate")
    with pytest.raises(ValueError, match="layout"):
        ou_cuda.check_deliver_operands(torch.zeros(1, 2, 2048)[..., :1024],
                                       None, x, torch.ones(1), "blend")
    with pytest.raises(ValueError, match="impl"):
        outer_nesterov(x, x, x, lr=1.0, mu=0.0, impl="pallas")


def test_auto_refuses_inputs_that_need_a_gradient():
    """The kernels have no backward: "auto" raises on any device when grad
    mode is on and an input requires grad (so a CPU run catches a training
    path that would cut the gradient on the card); "ref" and no_grad are
    fine."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.ones(8)
    with pytest.raises(RuntimeError, match="no backward"):
        rms_norm(x, w)
    rms_norm(x, w, impl="ref").sum().backward()
    assert x.grad is not None
    with torch.no_grad():
        rms_norm(x, w)
    p = torch.zeros(2, 1024, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        outer_nesterov(p, p.detach(), p.detach(), lr=1.0, mu=0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_deliver(p[None], None, p.detach(), torch.ones(1),
                      mode="blend", alpha=0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        delay_comp_array(p, p.detach(), p.detach(), tau=1.0, lam=0.5, H=1.0)
    q = torch.zeros(1, 2, 16, requires_grad=True)
    kv = torch.zeros(1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_decode(q, kv, kv, torch.zeros(8, dtype=torch.int32),
                     torch.tensor(0, dtype=torch.int32))
