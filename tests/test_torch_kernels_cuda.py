"""The port's hand-written kernels held against their plain PyTorch versions
on the card (`cuda`-marked: they skip without an NVIDIA GPU). This file
imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances (`assert_close`, shared with test_torch_kernels.py): f32 at
rtol = atol = 1e-5 (reduction order). bf16 at one bf16 ulp of each element
(|a - b| <= 2^-7 |ref|: a last-bit rounding flip), plus 1e-5 of the tensor's
magnitude for f32 reduction-order slack before the rounding.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.rms_norm.ops import rms_norm  # noqa: E402
from repro_torch.kernels.rms_norm.ref import rms_norm_ref  # noqa: E402

BF16_ULP = 2.0 ** -7
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(a) -> np.ndarray:
    """torch tensor (any device) or array-like -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def assert_close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = BF16_ULP * np.abs(want) + 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), \
            f"max excess {np.max(np.abs(got - want) - tol)}"


def decode_case(B, H, KV, hd, C, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    return q, k, v


def ragged_positions(B, C):
    """Every lane at its own depth: fresh, holes mid-cache, a wrapped ring,
    and an empty slot (lane 3)."""
    ar = np.arange(C)
    rows = [np.where(ar <= 5, ar, -1),
            np.where((ar <= C - 10) & (ar % 7 != 3), ar, -1),
            np.where(ar >= 20, ar + 30, np.where(ar < 10, ar + C + 30, -1)),
            np.full(C, -1)]
    qpos = [5, C - 10, C + 39, 0]
    return np.stack(rows[:B]).astype(np.int32), np.array(qpos[:B], np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 1024), (128, 128), (64, 1024), (5, 200)])
def test_rms_norm_kernel_matches_plain_on_card(cuda, shape, dtype):
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(TORCH_DT[dtype])
    w = torch.rand(shape[-1], generator=gen, device=cuda).to(TORCH_DT[dtype])
    got = rms_norm(x, w)
    torch.cuda.synchronize()
    assert_close(got, rms_norm_ref(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("G,hd,C", [(2, 128, 1024), (1, 64, 40), (16, 256, 70)])
def test_flash_decode_kernel_matches_plain_on_card(cuda, G, hd, C, window,
                                                   dtype):
    B, KV = 4, 2
    q, k, v = (torch.from_numpy(a).to(cuda, TORCH_DT[dtype])
               for a in decode_case(B, KV * G, KV, hd, C, seed=1))
    pos, qpos = (torch.from_numpy(a).to(cuda) for a in ragged_positions(B, C))
    got = flash_decode(q, k, v, pos, qpos, window=window)
    torch.cuda.synchronize()
    assert_close(got, flash_decode_ref(q, k, v, pos, qpos, window=window),
                 dtype)
    assert not got[3].any()                    # the empty slot gives 0
