"""The port's scan kernels (`wkv_scan`, `lru_scan`) held against the JAX
package's, on the same numpy inputs.

On the CPU each port kernel runs as its plain PyTorch version; it is compared
with the JAX package's Pallas kernel (interpret mode) and with its jnp
reference, at the JAX package's own tolerance for these kernels
(`tests/test_kernels.py`): rtol 1e-4, atol 1e-5 in f32. bf16 outputs at one
bf16 ulp of their magnitude (the scans widen to f32 and round o once; a sum
in another order can flip that last bit). `lru_scan` at T = 1 (the decode
step, the carry folded into b_0 + a_0 h0) is bitwise equal to JAX's. The
hand-written CUDA kernels are held to these plain versions on the card
(`tests/test_torch_kernels_cuda.py`).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ops import lru_scan as jax_lru_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import lru_scan_ref as jax_lru_ref  # noqa: E402
from repro.kernels.rwkv6_scan.ops import wkv_scan as jax_wkv_scan  # noqa: E402
from repro.models.rwkv6 import wkv_scan_ref as jax_wkv_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import lru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.rglru_scan import lru_scan_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import wkv_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import wkv_scan_cuda  # noqa: E402
from test_torch_kernels_cuda import (TORCH_DT, assert_close,  # noqa: E402,F401
                                     assert_scan_close, lru_case,
                                     one_torch_thread, wkv_case)


def assert_scan_close_as(got, want, dtype):
    if dtype == "float32":
        assert_scan_close(got, want)
    else:
        assert_close(got, want, dtype)


def _pair(a, dtype):
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(TORCH_DT[dtype]))


# ---------------------------------------------------------------------------
# wkv_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("T", [1, 37, 130])
def test_wkv_scan_plain_matches_jax(one_torch_thread, T, with_s0, dtype):
    B, H, hd = 2, 2, 16
    r, k, v, w, u, s0 = wkv_case(B, T, H, hd, seed=T + with_s0)
    s0 = s0 if with_s0 else None
    (rj, rt), (kj, kt), (vj, vt), (wj, wt) = (_pair(a, dtype)
                                              for a in (r, k, v, w))
    uj, ut = jnp.asarray(u), torch.from_numpy(u)
    sj = None if s0 is None else jnp.asarray(s0)
    st = None if s0 is None else torch.from_numpy(s0)
    o, sT = wkv_scan(rt, kt, vt, wt, ut, st)
    assert o.dtype == rt.dtype and sT.dtype == torch.float32
    for want_o, want_s in (jax_wkv_scan(rj, kj, vj, wj, uj, sj, bt=32),
                           jax_wkv_ref(rj, kj, vj, wj, uj, sj)):
        assert_scan_close_as(o, want_o, dtype)
        assert_scan_close(sT, want_s)


def test_wkv_state_carry_equals_full_scan(one_torch_thread):
    """Two calls carrying the state == one call over the whole sequence
    (the decode path carries S from step to step), and both match JAX."""
    B, T, H, hd = 2, 48, 2, 32
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in
                        wkv_case(B, T, H, hd, seed=11))
    o_full, s_full = wkv_scan(r, k, v, w, u)
    half = 17
    o1, s1 = wkv_scan(r[:, :half], k[:, :half], v[:, :half], w[:, :half], u)
    o2, s2 = wkv_scan(r[:, half:], k[:, half:], v[:, half:], w[:, half:], u,
                      s1)
    assert_scan_close(torch.cat([o1, o2], dim=1), o_full)
    assert_scan_close(s2, s_full)
    jo, js = jax_wkv_scan(*(jnp.asarray(a.numpy()) for a in (r, k, v, w, u)),
                          bt=16)
    assert_scan_close(o_full, jo)
    assert_scan_close(s_full, js)


# ---------------------------------------------------------------------------
# lru_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 300])
def test_lru_scan_plain_matches_jax(one_torch_thread, T, with_h0):
    B, D = 2, 130
    a, b, h0 = lru_case(B, T, D, seed=T + with_h0)
    h0 = h0 if with_h0 else None
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    hj = None if h0 is None else jnp.asarray(h0)
    got = lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                   None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.float32
    ref = jax_lru_ref(aj, bj, hj)
    assert_scan_close(got, ref)
    assert_scan_close(got, jax_lru_scan(aj, bj, hj, bt=64, bd=64))
    if T == 1:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_lru_scan_plain_follows_jax_associative_order(one_torch_thread):
    """Every length 1..40 (odd and even splits of the recursion): within a
    few f32 ulps of JAX's associative scan, and a = 1 gives the running
    sum."""
    rng = np.random.default_rng(5)
    for T in range(1, 41):
        a = rng.uniform(0.5, 1.0, (1, T, 8)).astype(np.float32)
        b = rng.standard_normal((1, T, 8)).astype(np.float32)
        got = lru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(jax_lru_ref(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ones = torch.ones(1, 33, 4)
    b = torch.from_numpy(rng.standard_normal((1, 33, 4)).astype(np.float32))
    np.testing.assert_allclose(lru_scan(ones, b).numpy(),
                               np.cumsum(b.numpy(), axis=1), rtol=1e-5,
                               atol=1e-5)


def test_scan_plain_versions_keep_the_graph(one_torch_thread):
    """impl="ref" is differentiable (the training forward runs it); "auto"
    refuses inputs that need a gradient (the kernels have no backward)."""
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in
                         wkv_case(1, 5, 2, 16, seed=3))
    r.requires_grad_(True)
    o, sT = wkv_scan(r, k, v, w, u, s0, impl="ref")
    (o.sum() + sT.sum()).backward()
    assert r.grad is not None and torch.isfinite(r.grad).all()
    with pytest.raises(RuntimeError, match="no backward"):
        wkv_scan(r, k, v, w, u, s0)
    a, b, h0 = (torch.from_numpy(x) for x in lru_case(1, 9, 6, seed=3))
    b.requires_grad_(True)
    lru_scan(a, b, h0, impl="ref").sum().backward()
    assert b.grad is not None and torch.isfinite(b.grad).all()
    with pytest.raises(RuntimeError, match="no backward"):
        lru_scan(a, b, h0)


def test_scan_launchers_refuse_cpu_tensors_and_bad_inputs():
    """The launchers never run on CPU tensors (no silent fallback) and
    reject what the kernels do not take."""
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in
                         wkv_case(1, 3, 2, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_scan_cuda(r, k, v, w, u, s0)
    bad = torch.zeros(1, 3, 2, 24)
    with pytest.raises(ValueError, match="hd in"):
        wkv_scan_cuda(bad, bad, bad, bad, torch.zeros(2, 24))
    with pytest.raises(TypeError, match="one dtype"):
        wkv_scan_cuda(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="s0 must be"):
        wkv_scan_cuda(r, k, v, w, u, s0[:, :1])
    a, b, h0 = (torch.from_numpy(x) for x in lru_case(1, 4, 6, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        lru_scan_cuda(a, b, h0)
    with pytest.raises(TypeError, match="float32"):
        lru_scan_cuda(a.double(), b.double())
    with pytest.raises(ValueError, match="h0 must be"):
        lru_scan_cuda(a, b, h0[:, :3])
    with pytest.raises(ValueError, match="impl"):
        lru_scan(a, b, impl="pallas")
