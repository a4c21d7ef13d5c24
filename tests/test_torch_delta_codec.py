"""The port's delta wire codec held against the JAX package's: the plain
encode/decode bitwise equal to JAX `encode_ref`/`decode_ref` (blocks 2, 130,
256 and 512, int8 and int4, ragged arrays, ties and zero blocks) and to the
Pallas kernels in interpret mode (blocks 256 and 512); `wire_bytes` equal on
a grid; and the engine transitions with the codec on (initiate and
diloco_round, both layouts, error feedback on and off) against the JAX
package's `make_engine_fns` at rtol 1e-5.

The pseudo-gradient mean feeding the codec is not bitwise across the
packages (ROADMAP.md Queue C: sums in another order), so an element lying
on a rounding boundary could take the neighbouring code; the engine test
counts the codes that differ and reports their share (0 on this grid).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import CoCoDCConfig as JaxCCfg  # noqa: E402
from repro.core import engine_state as jes  # noqa: E402
from repro.core.fragments import make_fragmenter as jax_fragmenter  # noqa: E402
from repro.kernels.delta_codec import ops as jops  # noqa: E402
from repro.kernels.delta_codec.delta_codec import (  # noqa: E402
    dequantize_unpack_2d, quantize_pack_2d)
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import CoCoDCConfig  # noqa: E402
from repro_torch.core import engine_state as es  # noqa: E402
from repro_torch.core.fragments import make_fragmenter  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels.delta_codec import ops  # noqa: E402
from repro_torch.kernels.delta_codec import ref as tref  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_kernels_cuda import codec_case, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CODECS = {"int8": 8, "int4": 4}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("case", ["ragged", "ties", "zero"])
@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("block", [2, 130, 256, 512])
def test_plain_codec_matches_jax_oracle(block, codec, case):
    x = codec_case(case, block, CODECS[codec], seed=block)
    jp, js = jops.encode_array(jnp.asarray(x), codec=codec, block=block,
                               impl="ref")
    tp, ts = ops.encode_array(torch.from_numpy(x), codec=codec, block=block)
    assert _bits_equal(tp.numpy(), jp) and _bits_equal(ts.numpy(), js)
    jd = jops.decode_array(jp, js, x.shape, jnp.float32, codec=codec,
                           block=block, impl="ref")
    td = ops.decode_array(tp, ts, x.shape, torch.float32, codec=codec,
                          block=block)
    assert _bits_equal(td.numpy(), jd)
    rt = ops.codec_roundtrip_array(torch.from_numpy(x), codec=codec,
                                   block=block)
    assert _bits_equal(rt.numpy(), jd)
    if case == "zero":
        assert not ts.numpy()[1].any() and not td.numpy().ravel()[
            block:2 * block].any()


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("block", [256, 512])
def test_plain_codec_matches_pallas_kernels_interpret(block, codec):
    bits = CODECS[codec]
    x = codec_case("ties", block, bits, seed=7).reshape(-1)
    x = np.concatenate([x, np.zeros(-x.size % block, np.float32)])
    x2d = x.reshape(-1, block)
    kp, ks = quantize_pack_2d(jnp.asarray(x2d), bits=bits, interpret=True)
    tp, ts = tref.encode_ref(torch.from_numpy(x2d), bits=bits)
    assert _bits_equal(tp.numpy(), kp) and _bits_equal(ts.numpy(), ks)
    kd = dequantize_unpack_2d(kp, ks, bits=bits, interpret=True)
    assert _bits_equal(tref.decode_ref(tp, ts, bits=bits).numpy(), kd)


def test_wire_bytes_matches_jax():
    for codec in CODECS:
        for block in (2, 130, 256, 4096, 65536):
            for n in (0, 1, 2, 129, 256, 1000, 45_814_784, 134_105_856):
                assert ops.wire_bytes(n, codec=codec, block=block) == \
                    jops.wire_bytes(n, codec=codec, block=block)
    # paper_150m fragment 0 at block 256: the ratios the chip run reports
    n = 45_814_784
    assert 4 * n / ops.wire_bytes(n, codec="int8", block=256) == \
        pytest.approx(3.938, abs=1e-3)
    assert 4 * n / ops.wire_bytes(n, codec="int4", block=256) == \
        pytest.approx(7.758, abs=1e-3)


def test_tree_roundtrip_keeps_none_leaves_and_refuses_bad_blocks():
    x = torch.linspace(-1, 1, 300).reshape(3, 100)
    tree = {"a": x, "b": None, "c": {"d": x[0]}}
    out = ops.codec_roundtrip(tree, codec="int4", block=130)
    assert out["b"] is None and out["a"].shape == (3, 100)
    assert torch.equal(out["c"]["d"], ops.codec_roundtrip_array(
        x[0], codec="int4", block=130))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.encode_array(x, codec="int8", block=256, impl="pallas")
    # a wrapper on a tensor that needs a gradient refuses on any device
    with pytest.raises(RuntimeError, match="no backward"):
        ops.encode_array(x.clone().requires_grad_(), codec="int8", block=256)


M = 3
EVENTS = [("init", 0, 1), ("init", 2, 3), ("deliver", 4, 1),
          ("init", 5, 1), ("init", 6, 0), ("deliver", 7, 3),
          ("round", 11, None), ("round", 12, None)]


def _engines(method, fused, codec, ef, block):
    kw = dict(num_workers=M, local_steps=12, num_fragments=4,
              overlap_depth=3, fused_updates=fused, comp_lambda=0.4,
              wire_codec=codec, codec_block=block, codec_error_feedback=ef)
    jcfg, tcfg = jax_config("bench_tiny"), get_config("bench_tiny")
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jstack = jax.tree.map(lambda a: jnp.stack([a] * M), jp)
    tstack = tree_map(lambda a: a[None].repeat((M,) + (1,) * a.dim()), tp)
    jfrag = jax_fragmenter(jcfg, jax.eval_shape(lambda: jp), 4)
    tfrag = make_fragmenter(tcfg, api.param_specs(tcfg), 4)
    j = (jes.init_state(method, JaxCCfg(**kw), jstack, frag=jfrag),
         jes.make_engine_fns(method, JaxCCfg(**kw), jfrag, use_jit=False),
         jstack)
    t = (es.init_state(method, CoCoDCConfig(**kw), tstack, frag=tfrag),
         es.make_engine_fns(method, CoCoDCConfig(**kw), tfrag), tstack)
    return j, t


def _perturb(jstack, tstack, rng):
    """The same N(0, 1e-2) noise on both packages' worker stacks."""
    noise = [(rng.standard_normal(a.shape) * 1e-2).astype(np.float32)
             for a in jax.tree.leaves(jstack)]
    it = iter(noise)
    for leaf, n in zip(tree_leaves(tstack), noise):
        leaf.add_(torch.from_numpy(n))
    return jax.tree.map(lambda a: a + next(it), jstack)


def _np(x):
    return [x.numpy()] if isinstance(x, torch.Tensor) else \
        [np.asarray(a) for a in jax.tree.leaves(
            x, is_leaf=lambda a: isinstance(a, torch.Tensor))]


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method,codec,block", [
    ("cocodc", "int8", 256), ("streaming", "int4", 130),
    ("diloco", "int8", 130)])
def test_codec_transitions_match_jax(method, codec, block, fused, ef,
                                     capsys):
    (jst, jfn, jstack), (tst, tfn, tstack) = _engines(method, fused, codec,
                                                      ef, block)
    assert (tst.wire_residual is None) == (jst.wire_residual is None) == \
        (not ef)
    rng = np.random.default_rng(1)
    flips = total = 0
    for kind, t, p in EVENTS:
        jstack = _perturb(jstack, tstack, rng)
        if (kind == "round") != (method == "diloco"):
            continue
        if kind == "round":
            jst, jstack = jfn.diloco_round(jst, jstack)
            tst, tstack = tfn.diloco_round(tst, tstack)
            moved = (_np(tst.theta_g), _np(jst.theta_g))
        elif kind == "init":
            jst = jfn.initiate(jst, t, jstack, p)
            tst = tfn.initiate(tst, t, tstack, p)
            moved = (_np(tst.inflight_delta), _np(jst.inflight_delta))
        else:
            jst, jstack = jfn.deliver(jst, t, jstack, p)
            tst, tstack = tfn.deliver(tst, t, tstack, p)
            moved = None
        if moved is not None:
            # codes that differ: post-codec values further apart than the
            # rtol 1e-5 an agreeing code allows
            for a, b in zip(*moved):
                flips += int((np.abs(a - b) > 1e-5 * np.abs(b) + 1e-7).sum())
                total += a.size
        for f in ("theta_g", "momentum", "inflight_delta", "wire_residual",
                  "delta_norm", "rate"):
            a, b = getattr(tst, f), getattr(jst, f)
            assert (a is None) == (b is None), f
            if a is not None:
                for x, y in zip(_np(a), _np(b)):
                    np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7,
                                               err_msg=f"{f} after {kind} "
                                                       f"t={t}")
        for x, y in zip(_np(tstack), _np(jstack)):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7)
    with capsys.disabled():
        print(f"\n[{method} {codec} block {block} fused={fused} ef={ef}] "
              f"codes that differ: {flips}/{total}")
    assert flips == 0


def test_codec_none_state_has_no_residual_and_pre_codec_dict_restores():
    """Codec off: no residual field value. A state dict without
    `wire_residual` (a pre-codec checkpoint) restores into a codec engine
    with the fresh zero residual; a present one round-trips exactly."""
    (_, _, _), (st, fn, stack) = _engines("cocodc", True, "none", True, 256)
    assert st.wire_residual is None
    (_, _, _), (st, fn, stack) = _engines("cocodc", True, "int8", True, 256)
    for leaf in tree_leaves(stack):
        leaf.add_(0.01)
    st = fn.initiate(st, 0, stack, 1)
    assert st.wire_residual.abs().max() > 0
    d = es.state_to_dict(st)
    (_, _, _), (fresh, _, _) = _engines("cocodc", True, "int8", True, 256)
    back = es.state_from_dict(fresh, d)
    assert torch.equal(back.wire_residual, st.wire_residual)
    d.pop("wire_residual")
    (_, _, _), (fresh, _, _) = _engines("cocodc", True, "int8", True, 256)
    back = es.state_from_dict(fresh, d)
    assert not back.wire_residual.any()
    assert torch.equal(back.inflight_delta, st.inflight_delta)


@pytest.mark.parametrize("block", [2, 65536])
def test_codec_blocks_at_the_spec_edges_match_jax(block):
    """The blocks at the edges of what the spec admits run an initiation
    (no alignment fallback or refusal) and park the JAX engine's payload."""
    (jst, jfn, jstack), (st, fn, stack) = _engines(
        "streaming", False, "int4", True, block)
    jstack = _perturb(jstack, stack, np.random.default_rng(block))
    st = fn.initiate(st, 0, stack, 0)
    jst = jfn.initiate(jst, 0, jstack, 0)
    assert st.wire_residual["embed"].abs().max() > 0
    for x, y in zip(_np(st.inflight_delta), _np(jst.inflight_delta)):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7)
