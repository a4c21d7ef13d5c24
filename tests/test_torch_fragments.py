"""The port's fragmentation and flat plane held against the JAX package's:
identical leaf-to-fragment plans, fragment bytes, flat-plane row spans and
per-leaf offsets for bench_tiny and paper_150m at full width (shapes only,
no allocation) under every strategy; and `pack`/`unpack` (with and without
the worker axis) round-trip and agree with JAX on bench_tiny values.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.fragments import make_fragmenter as jax_fragmenter  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fragments import make_fragmenter  # noqa: E402
from repro_torch.core.tree import leaves_with_path, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STRATEGIES = ["strided", "contiguous", "skewed"]


def _pair(arch, k, strategy):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    shape = jax.eval_shape(lambda: jax_api.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return (jax_fragmenter(jcfg, shape, k, strategy=strategy),
            make_fragmenter(tcfg, api.param_specs(tcfg), k,
                            strategy=strategy))


def _chunks(flat, p):
    return [(c.path, c.offset, c.size, c.rows, tuple(c.shape))
            for c in flat._chunks[p]]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch,k", [("bench_tiny", 4), ("paper_150m", 4),
                                    ("paper_150m", 3)])
def test_plans_and_flat_layout_match_jax(arch, k, strategy):
    jf, tf = _pair(arch, k, strategy)
    assert tf.owners() == jf.owners()
    assert tf.total_bytes == jf.total_bytes
    for p in range(k):
        assert tf.fragment_bytes(p) == jf.fragment_bytes(p)
        assert tf.flat.row_span(p) == jf.flat.row_span(p)
        assert tf.flat.elems(p) == jf.flat.elems(p)
        assert _chunks(tf.flat, p) == _chunks(jf.flat, p)
    assert tf.flat.total_rows == jf.flat.total_rows


def test_paper_150m_strided_row_spans():
    _, tf = _pair("paper_150m", 4, "strided")
    assert [tf.flat.row_span(p) for p in range(4)] == [
        (0, 44741), (44741, 89482), (89482, 110224), (110224, 130965)]
    assert tf.total_bytes == 134_105_856 * 4


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pack_unpack_roundtrip_and_match_jax(strategy):
    jf, tf = _pair("bench_tiny", 4, strategy)
    jcfg, tcfg = jax_config("bench_tiny"), get_config("bench_tiny")
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    jstack = jax.tree.map(
        lambda a: np.stack([np.asarray(a) + rng.standard_normal(a.shape)
                            .astype(np.float32) for _ in range(3)]), jp)
    tstack = tree_map(lambda a: torch.from_numpy(a.copy()), jstack)
    for p in range(4):
        got = tf.flat.pack(tp, p)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jf.flat.pack(jp, p)))
        gs = tf.flat.pack_stack(tstack, p)
        np.testing.assert_array_equal(gs.numpy(),
                                      np.asarray(jf.flat.pack_stack(jstack, p)))
        # unpack writes the buffer back in place: a zero tree fills up with
        # exactly fragment p's elements
        zero = tree_map(torch.zeros_like, tstack)
        tf.flat.unpack_stack(zero, p, gs)
        want = jf.flat.unpack_stack(
            jax.tree.map(jax.numpy.zeros_like, jstack), p,
            jf.flat.pack_stack(jstack, p))
        for a, b in zip(tree_leaves(zero), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    full = tf.flat.pack_full(tstack, worker_axis=True)
    back = tf.flat.unpack_full(tree_map(torch.zeros_like, tstack), full,
                               worker_axis=True)
    for (path, a), b in zip(leaves_with_path(back), tree_leaves(tstack)):
        assert torch.equal(a, b), path


def test_extract_insert_match_jax():
    jf, tf = _pair("bench_tiny", 4, "strided")
    jcfg, tcfg = jax_config("bench_tiny"), get_config("bench_tiny")
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(4))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    for p in range(4):
        je, te = jf.extract(jp, p), tf.extract(tp, p)
        jl = jax.tree.leaves(je, is_leaf=lambda x: x is None)
        tl = [leaf for _, leaf in leaves_with_path(te)]
        assert [x is None for x in jl] == [x is None for x in tl]
        for a, b in zip(tl, jl):
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        doubled = tree_map(lambda a: a * 2, te)
        out = tf.insert(tree_map(torch.clone, tp), p, doubled)
        want = jf.insert(jp, p, jax.tree.map(
            lambda a: None if a is None else a * 2, je,
            is_leaf=lambda x: x is None))
        for a, b in zip(tree_leaves(out), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
