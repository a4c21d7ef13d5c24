"""The port's recurrent families — RWKV-6 (ssm) and the RecurrentGemma hybrid
— held against the JAX package's, on the same params (`params_from_jax`)
and the same numpy inputs.

Params: the JAX init with every leaf moved by N(0, 0.05) noise, so the
leaves it sets to 0 (mu, lora_b, wb, u, the biases) take part too. The
hybrid runs at 5 layers: one (rglru, rglru, attn) group plus 2 remainder
blocks (the ``rem`` list).

Tolerances: f32 compute at rtol 1e-4, atol 1e-5 of the largest magnitude
(the scans' tolerance; the two frameworks' matmuls sum in other orders).
bf16 compute against the JAX functions run op by op (`jax.disable_jit`):
the port rounds where JAX's operations do, and agrees within 2 bf16 ulps of
the logits' magnitude. Under `jit`, XLA keeps fused bf16 chains in f32
(excess precision), which no eager program reproduces: token identity is
held at f32 compute (tests/test_torch_lockstep.py).
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
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, rglru, rwkv6  # noqa: E402
from repro_torch.weights import flatten, params_from_jax, unflatten  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

BF16_ULP = 2.0 ** -7
ARCHS = [("rwkv6_3b", None), ("recurrentgemma_9b", 5)]


def configs(arch, n_layers=None, compute="float32"):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    kw = {"compute_dtype": compute}
    if n_layers:
        kw["n_layers"] = n_layers
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw))


def both_params(jcfg, tcfg, seed=0):
    """(JAX params as jnp, the port's master params on the CPU)."""
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.standard_normal(a.shape).astype(np.float32) * 0.05,
        jax_api.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tcfg, tree, "cpu")


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_f32_close(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# params and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_params_from_jax_covers_every_leaf(one_torch_thread, arch, n_layers):
    jcfg, tcfg = configs(arch, n_layers)
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = flatten(tp)
    assert set(jflat) == set(tflat)
    for path, leaf in jflat.items():
        np.testing.assert_array_equal(tflat[path].numpy(), leaf)
    # the port's own init draws the same tree of shapes, with the JAX
    # package's constant leaves
    own = flatten(api.init_params(tcfg, torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jflat.items()}
    consts = rwkv6.CONSTS if tcfg.family == "ssm" else rglru.CONSTS
    for path, leaf in own.items():
        name = path.split("/")[-1]
        if name in consts:
            np.testing.assert_array_equal(leaf.numpy(), jflat[path])


def test_flatten_roundtrips_the_hybrid_tree_with_its_list():
    jcfg, tcfg = configs("recurrentgemma_9b", 5)
    shapes = rglru.param_shapes(tcfg)
    assert len(shapes["rem"]) == 2
    flat = flatten(shapes)
    assert "rem/0/mixer/wa" in flat and "rem/1/mlp/w_up" in flat
    assert unflatten(flat) == shapes
    # the JAX package's own tree, leaf for leaf
    jp = jax.tree.map(np.asarray,
                      jax_api.init_params(jcfg, jax.random.PRNGKey(1)))
    back = unflatten(flatten(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    # reduced (3 layers): no remainder block, an empty list
    assert configs("recurrentgemma_9b")[1].n_layers == 3
    assert rglru.param_shapes(configs("recurrentgemma_9b")[1])["rem"] == []
    broken = jax.tree.map(np.asarray, jp)
    del broken["rem"][1]["mixer"]["wa"]
    with pytest.raises(ValueError, match="rem/1/mixer/wa"):
        params_from_jax(tcfg, broken)


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 19])
def test_time_mix_and_channel_mix_match_jax(one_torch_thread, T):
    jcfg, tcfg = configs("rwkv6_3b")
    jp, tp = both_params(jcfg, tcfg)
    rng = np.random.default_rng(T)
    B, D = 2, tcfg.d_model
    H, hd = D // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    x, xp = _x(rng, B, T, D), _x(rng, B, T, D)
    s0 = _x(rng, B, H, hd, hd)
    jtm = _layer(jp["layers"]["tm"], 1)
    ttm = {k: v[1] for k, v in tp["layers"]["tm"].items()}
    jy, js = jax_rwkv6.time_mix(jcfg, jnp.asarray(x), jnp.asarray(xp), jtm,
                                s0=jnp.asarray(s0))
    ty, ts = rwkv6.time_mix(tcfg, torch.from_numpy(x), torch.from_numpy(xp),
                            ttm, s0=torch.from_numpy(s0))
    assert_f32_close(ty, jy)
    assert_f32_close(ts, js)
    jcm = _layer(jp["layers"]["cm"], 1)
    tcm = {k: v[1] for k, v in tp["layers"]["cm"].items()}
    assert_f32_close(
        rwkv6.channel_mix(torch.from_numpy(x), torch.from_numpy(xp), tcm),
        jax_rwkv6.channel_mix(jnp.asarray(x), jnp.asarray(xp), jcm))
    np.testing.assert_array_equal(
        rwkv6._shift(torch.from_numpy(x), torch.from_numpy(xp[:, 0])).numpy(),
        np.asarray(jax_rwkv6._shift(jnp.asarray(x), jnp.asarray(xp[:, 0]))))


@pytest.mark.parametrize("T,with_state", [(1, True), (23, True),
                                          (23, False)])
def test_rglru_mixer_matches_jax(one_torch_thread, T, with_state):
    jcfg, tcfg = configs("recurrentgemma_9b", 5)
    jp, tp = both_params(jcfg, tcfg)
    rng = np.random.default_rng(T)
    B, D = 2, tcfg.d_model
    x = _x(rng, B, T, D)
    jm = jax.tree.map(lambda a: a[0], jp["rem"][1]["mixer"])
    tm = {k: v[0] for k, v in tp["rem"][1]["mixer"].items()}
    state = ({"conv": _x(rng, B, rglru.CONV_WIDTH - 1, D),
              "h": _x(rng, B, D)} if with_state else None)
    jy, jst = jax_rglru.rglru_mixer_apply(
        jcfg, jnp.asarray(x), jm,
        None if state is None else jax.tree.map(jnp.asarray, state))
    ty, tst = rglru.rglru_mixer_apply(
        tcfg, torch.from_numpy(x), tm,
        None if state is None else {k: torch.from_numpy(v)
                                    for k, v in state.items()})
    assert_f32_close(ty, jy)
    assert_f32_close(tst["h"], jst["h"])
    assert_f32_close(tst["conv"], jst["conv"])


# ---------------------------------------------------------------------------
# forward / loss / decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_forward_and_loss_match_jax(one_torch_thread, arch, n_layers):
    jcfg, tcfg = configs(arch, n_layers)
    jp, tp = both_params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 21)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 21)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jh, _ = jax_api.forward(jcfg, jp, jb, train=False)
    flag = "wkv_impl" if tcfg.family == "ssm" else "lru_impl"
    for impl in ("ref", "kernel"):
        with torch.no_grad():
            assert_f32_close(api.forward(tcfg, tp, tb, **{flag: impl}), jh)
    jl, _ = jax_api.loss_fn(jcfg, jp, jb, xent_chunk=8)
    leaves = flatten(tp)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tl, metrics = api.loss_fn(tcfg, tp, tb, xent_chunk=8)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert metrics["nll"] is tl
    # the training forward is differentiable through the plain scan: the
    # scan's own parameters (the bonus u, the RG-LRU's Lambda) get gradients
    tl.backward()
    scan_leaf = ("layers/tm/u" if tcfg.family == "ssm"
                 else "layers/p0/mixer/lam")
    assert leaves[scan_leaf].grad.abs().sum() > 0
    assert all(torch.isfinite(leaf.grad).all() for leaf in leaves.values())


@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_decode_steps_match_jax(one_torch_thread, arch, n_layers):
    """Decode steps past the hybrid's ring wrap (C = 8): logits and every
    cache entry vs the jitted JAX decode step, at f32."""
    jcfg, tcfg = configs(arch, n_layers)
    jp, tp = both_params(jcfg, tcfg)
    cp = api.prepare_params(tcfg, tp)
    B, C = 3, 8
    jc = jax_api.init_cache(jcfg, B, C)
    tc = api.init_cache(tcfg, B, C, "cpu")
    decode = jax.jit(lambda p, c, t: jax_api.decode_step(jcfg, p, c, t))
    rng = np.random.default_rng(4)
    for _ in range(11):
        toks = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(toks))
        tl, tc = api.decode_step(tcfg, cp, tc, torch.from_numpy(toks))
        assert_f32_close(tl, jl)
    assert tc["pos"] == int(jc["pos"]) == 11
    jflat = flatten(jax.tree.map(np.asarray, {k: v for k, v in jc.items()
                                              if k != "pos"}))
    tflat = flatten({k: v for k, v in tc.items() if k != "pos"})
    assert set(jflat) == set(tflat)
    for path, want in jflat.items():
        if path == "kv_pos":
            np.testing.assert_array_equal(tflat[path].numpy(), want)
        else:
            assert_f32_close(tflat[path], want)


@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_bf16_decode_rounds_as_jax_ops_do(one_torch_thread, arch, n_layers):
    """bf16 compute: two decode steps against the JAX decode run op by op
    (`jax.disable_jit`), within 2 bf16 ulps of the logits' magnitude."""
    jcfg, tcfg = configs(arch, n_layers, compute="bfloat16")
    jp, tp = both_params(jcfg, tcfg, seed=2)
    cp = api.prepare_params(tcfg, tp)
    B = 2
    jc = jax_api.init_cache(jcfg, B, 16)
    tc = api.init_cache(tcfg, B, 16, "cpu")
    assert tc["s" if tcfg.family == "ssm" else "kv_pos"].device.type == "cpu"
    for toks in ([3, 90], [17, 4]):
        toks = np.asarray(toks, np.int32)
        with jax.disable_jit():
            jl, jc = jax_api.decode_step(jcfg, jp, jc, jnp.asarray(toks),
                                         unroll=True)
        tl, tc = api.decode_step(tcfg, cp, tc, torch.from_numpy(toks))
        want = np.asarray(jl)
        assert np.abs(tl.numpy() - want).max() <= \
            2 * BF16_ULP * np.abs(want).max()
