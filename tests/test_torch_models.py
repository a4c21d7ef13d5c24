"""The port's dense transformer held against the JAX package's, on the same
params (`weights.params_from_jax`) and the same numpy inputs.

Tolerances: f32 compute at rtol = atol = 1e-4 for logits and caches (the
summation order of the two frameworks' matmuls differs). bf16 compute at two
bf16 ulps of the logits' magnitude: XLA and PyTorch round a few bf16
elementwise products differently (about 1 element in 10^3 per layer),
and those one-ulp flips compound through the layers.
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
from repro.models import transformer as jax_tr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.weights import flatten, params_from_jax  # noqa: E402

BF16_ULP = 2.0 ** -7

# (arch, reduced, compute dtype override)
CASES = [("bench_tiny", False, None),
         ("qwen3_0_6b", True, "float32"),
         ("qwen3_0_6b", True, None)]


def _configs(arch, reduced, compute):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    if compute:
        jcfg = dataclasses.replace(jcfg, compute_dtype=compute)
        tcfg = dataclasses.replace(tcfg, compute_dtype=compute)
    return jcfg, tcfg


def _both_params(jcfg, tcfg, seed=0):
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _assert_logits(got, want, compute):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        tol = 2 * BF16_ULP * np.abs(want).max()
        assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("arch,reduced", [("bench_tiny", False),
                                          ("qwen3_0_6b", True),
                                          ("paper_150m", True)])
def test_params_from_jax_covers_every_leaf(arch, reduced):
    jcfg, tcfg = _configs(arch, reduced, None)
    jp, tp = _both_params(jcfg, tcfg)
    jflat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = flatten(tp)
    assert set(jflat) == set(tflat)
    for path, leaf in jflat.items():
        assert tflat[path].dtype == torch.float32
        np.testing.assert_array_equal(tflat[path].numpy(), leaf)
    # the port's own init draws the same tree of shapes
    own = flatten(api.init_params(tcfg, torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jflat.items()}
    broken = jax.tree.map(np.asarray, jp)
    del broken["layers"]["attn"]["wq"]
    with pytest.raises(ValueError, match="layers/attn/wq"):
        params_from_jax(tcfg, broken)


@pytest.mark.parametrize("arch,reduced,compute", CASES)
def test_prefill_and_decode_match_jax(arch, reduced, compute):
    """Chunked prefill of two slots (one prompt spans two chunks), then
    decode steps with one slot inactive: logits and caches vs JAX."""
    jcfg, tcfg = _configs(arch, reduced, compute)
    compute = tcfg.compute_dtype
    jp, tp = _both_params(jcfg, tcfg)
    cp = api.prepare_params(tcfg, tp)
    B, C, Pc = 3, 32, 8
    jc = jax_tr.init_slot_cache(jcfg, B, C)
    tc = api.init_slot_cache(tcfg, B, C, device="cpu")
    rng = np.random.default_rng(0)
    for slot, plen in ((0, 7), (1, 12)):
        for start in range(0, plen, Pc):
            n = min(Pc, plen - start)
            toks = rng.integers(0, jcfg.vocab, size=Pc).astype(np.int32)
            jl, jc = jax_tr.prefill_chunk_slotted(jcfg, jp, jc,
                                                  jnp.asarray(toks), slot,
                                                  start, n)
            tl, tc = api.prefill_chunk_slotted(tcfg, cp, tc,
                                               torch.from_numpy(toks), slot,
                                               start, n)
            _assert_logits(tl, jl, compute)
    active = np.array([True, True, False])
    last = np.array([5, 9, 3], np.int32)
    for _ in range(3):
        jl, jc = jax_tr.decode_step_slotted(jcfg, jp, jc, jnp.asarray(last),
                                            active=jnp.asarray(active))
        tl, tc = api.decode_step_slotted(tcfg, cp, tc, torch.from_numpy(last),
                                         active=torch.from_numpy(active))
        _assert_logits(tl[active], np.asarray(jl)[active], compute)
        last = np.asarray(jl).argmax(-1).astype(np.int32)
    for key in ("kv_pos", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    for key in ("k", "v"):
        want = np.asarray(jc[key].astype(jnp.float32))
        got = tc[key].float().numpy()
        if compute == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(got - want).max() <= 2 * BF16_ULP * np.abs(want).max()


def test_unported_families_raise():
    tcfg = dataclasses.replace(get_config("bench_tiny"), family="audio")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.init_slot_cache(tcfg, 2, 8, device="cpu")
