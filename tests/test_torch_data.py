"""The port's data pipeline held against the JAX package's: the same
successor tables and the same tokens, over a grid of seeds, worker ids (-1
is the eval stream), steps, batch sizes, sequence lengths and both vocab
sizes the training slice runs (bench_tiny's 512, paper_150m's 32000).

The port draws JAX's threefry stream with numpy (`repro_torch.data.prng`):
the key splits and `randint` must be bit-exact; the Gumbel-max choice goes
through a float32 log that may differ from XLA's in the last ulp, which
could flip an argmax between two near-equal candidates. On this grid no
token differs, and the test requires exactly that.
"""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import pipeline as jax_pipe  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.data import prng  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_key_ops_bit_exact(seed):
    k, kn = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert np.array_equal(np.asarray(k), kn)
    for data in (0, 3, 10_000_000):
        assert np.array_equal(np.asarray(jax.random.fold_in(k, data)),
                              prng.fold_in(kn, data))
    for n in (2, 7, 257):
        assert np.array_equal(np.asarray(jax.random.split(k, n)),
                              prng.split(kn, n))
    for lo, hi, shape in ((0, 512, (9,)), (0, 32000, (8,)), (3, 70000, (5,))):
        assert np.array_equal(
            np.asarray(jax.random.randint(k, shape, lo, hi)),
            prng.randint(kn, shape, lo, hi))
    tiny = np.finfo(np.float32).tiny
    assert np.array_equal(
        np.asarray(jax.random.uniform(k, (6, 40), minval=tiny, maxval=1.0)),
        prng.uniform01_tiny(kn, (6, 40)))


@pytest.mark.parametrize("vocab", [512, 32000])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("worker", [-1, 0, 3])
def test_batches_match_jax_tokens(vocab, seed, worker):
    frac = 0.0 if worker < 0 else 0.25
    jc = jax_pipe.MarkovCorpus(vocab=vocab, seed=seed, worker_id=worker,
                               noniid_frac=frac)
    tc = pipe.MarkovCorpus(vocab=vocab, seed=seed, worker_id=worker,
                           noniid_frac=frac)
    assert np.array_equal(jc.succ, tc.succ)
    for step in (0, 17, 10_000_001):
        for B, S in ((4, 32), (8, 256), (3, 7)):
            want = jc.batch(step, B, S)
            got = tc.batch(step, B, S)
            for key in ("tokens", "labels"):
                assert got[key].dtype == np.int32
                assert np.array_equal(np.asarray(want[key]), got[key]), \
                    (step, B, S, key)


def test_segments_and_worker_stacks_match_jax():
    jstreams = jax_pipe.make_worker_streams(4, 512, seed=1, noniid_frac=0.3)
    tstreams = pipe.make_worker_streams(4, 512, seed=1, noniid_frac=0.3)
    want = jax_pipe.stacked_segment(jstreams, 5, 3, 4, 16)
    got = pipe.stacked_segment(tstreams, 5, 3, 4, 16)
    for key in ("tokens", "labels"):
        assert got[key].shape == (3, 4, 4, 16)
        assert np.array_equal(np.asarray(want[key]), got[key])
    b = pipe.stacked_batch(tstreams, 6, 4, 16)
    assert np.array_equal(b["tokens"], got["tokens"][1])
    seg = tstreams[2].segment(9, 2, 4, 16)
    assert np.array_equal(seg["labels"][1],
                          tstreams[2].batch(10, 4, 16)["labels"])
