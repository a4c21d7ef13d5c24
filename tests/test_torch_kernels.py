"""The port's kernels held against the JAX package's, on the same numpy inputs.

On the CPU each port kernel runs as its plain PyTorch version; it is compared
with the JAX package's Pallas kernel (interpret mode) and with its jnp
reference. The tolerances are `assert_close`'s, in test_torch_kernels_cuda.py,
which holds the hand-written kernels against the plain versions on the card.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode.ops import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_fd_ref  # noqa: E402
from repro.kernels.rms_norm.ops import rms_norm as jax_rms_ops  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import flash_decode_cuda  # noqa: E402
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.rms_norm.ops import rms_norm  # noqa: E402
from repro_torch.kernels.rms_norm.rms_norm import rms_norm_triton  # noqa: E402
from test_torch_kernels_cuda import (TORCH_DT, assert_close,  # noqa: E402
                                     decode_case, ragged_positions)


def _pair(a, dtype):
    """numpy f32 -> (jax array, torch tensor), both rounded to `dtype`."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TORCH_DT[dtype])


# ---------------------------------------------------------------------------
# rms_norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 96), (3, 5, 128), (7, 200)])
def test_rms_norm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)
    got = rms_norm(xt, wt, 1e-6)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert_close(got, jax_rms_norm(xj, wj, 1e-6), dtype)
    assert_close(got, jax_rms_ops(xj, wj, 1e-6, impl="pallas"), dtype)


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("C", [64, 40])            # 40: not a block multiple
def test_flash_decode_plain_matches_jax_ragged(C, window, dtype):
    B, H, KV, hd = 4, 4, 2, 32
    q, k, v = decode_case(B, H, KV, hd, C, seed=C)
    pos, qpos = ragged_positions(B, C)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    got = flash_decode(qt, kt, vt, torch.from_numpy(pos),
                       torch.from_numpy(qpos), window=window)
    assert got.dtype == qt.dtype
    # the TPU kernel (interpret mode), every row: the empty slot gives 0
    want = jax_flash_decode(qj, kj, vj, jnp.asarray(pos), jnp.asarray(qpos),
                            window=window, bc=32, impl="pallas")
    assert_close(got, want, dtype)
    assert not got[3].any()
    # the jnp reference gives the mean of V on a row with no valid key:
    # compare only rows with one
    ref = jax_fd_ref(qj, kj, vj, jnp.asarray(pos), jnp.asarray(qpos),
                     window=window)
    assert_close(got[:3], ref[:3], dtype)


def test_flash_decode_shared_positions_broadcast():
    """Shared (C,)/() positions == the explicitly broadcast per-slot form,
    and match the TPU kernel."""
    B, H, KV, hd, C = 2, 4, 2, 32, 48
    q, k, v = decode_case(B, H, KV, hd, C, seed=7)
    pos = np.where(np.arange(C) <= 30, np.arange(C), -1).astype(np.int32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    a = flash_decode(qt, kt, vt, torch.from_numpy(pos), torch.tensor(30))
    b = flash_decode(qt, kt, vt, torch.from_numpy(pos)[None].expand(B, C),
                     torch.full((B,), 30, dtype=torch.int32))
    assert torch.equal(a, b)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), jnp.asarray(30, jnp.int32),
                            bc=16, impl="pallas")
    assert_close(a, want, "float32")


def test_flash_decode_reads_cache_layer_through_strides():
    """A layer of the (L, B, C, KV, hd) cache and a contiguous copy give the
    same result (the kernel reads the layer through its strides)."""
    B, H, KV, hd, C = 3, 4, 2, 16, 24
    q, k, v = decode_case(B, H, KV, hd, C, seed=3)
    kk = torch.from_numpy(np.stack([k, -k]))[1]
    vv = torch.from_numpy(np.stack([v, v * 2]))[1]
    pos = torch.arange(C, dtype=torch.int32)
    a = flash_decode(torch.from_numpy(q), kk, vv, pos, torch.tensor(C - 1))
    b = flash_decode_ref(torch.from_numpy(q), kk.contiguous(), vv.contiguous(),
                         pos[None].expand(B, C), torch.full((B,), C - 1,
                                                            dtype=torch.int32))
    assert torch.equal(a, b)


def test_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """The kernels' launchers never run on CPU tensors (no silent fallback)
    and reject shapes the kernel does not take."""
    q, k, v = (torch.from_numpy(a) for a in decode_case(1, 2, 1, 16, 8, 0))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    qpos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_cuda(q, k, v, pos, qpos)
    with pytest.raises(ValueError, match="G <= 16"):
        flash_decode_cuda(torch.zeros(1, 17, 16), torch.zeros(1, 8, 1, 16),
                          torch.zeros(1, 8, 1, 16), pos, qpos)
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_triton(torch.zeros(2, 8), torch.ones(8))
    with pytest.raises(ValueError, match="impl"):
        rms_norm(torch.zeros(2, 8), torch.ones(8), impl="pallas")
