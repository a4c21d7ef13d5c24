"""The port's lock-step serving path (SSM and hybrid families) held against
the JAX package's (`repro/launch/serve.py::_serve_lockstep`): the same
prompts (`jax.random.randint`'s draw, here from the port's numpy threefry),
the same greedy tokens at f32 compute and the same sampled tokens at
temperature 0.8 (threefry keys fold_in(key, 0x5A17) then the step, Gumbel
draws over the whole (B, V) logits), for reduced rwkv6 and the 5-layer
hybrid, with P = 48 and G = 40 so the hybrid's 64-token attention ring
wraps; a per-leaf checkpoint written by the JAX package serves the same
tokens; the CLI runs on the CPU.

`jax_lockstep` is the JAX function's loop returning all (B, G) tokens (the
function itself prints the first 16 of up to 4 sequences); the test checks
the copy against the function's own printout.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_pytree  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.data import prng  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401
from test_torch_recurrent import ARCHS, both_params, configs  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_lockstep(cfg, params, B, P, G, temperature, seed):
    """`repro.launch.serve._serve_lockstep`'s loop, returning the prompts
    and every generated token."""
    key = jax.random.PRNGKey(seed)
    prompts = jax.random.randint(key, (B, P), 0, cfg.vocab)
    cache_len = jax_api.decode_cache_len(cfg, P + G)
    decode = jax.jit(lambda p, c, t: jax_api.decode_step(cfg, p, c, t))
    cache = jax_api.init_cache(cfg, B, max(cache_len, P + G))
    for t in range(P):
        logits, cache = decode(params, cache, prompts[:, t])
    sample_key = jax.random.fold_in(key, 0x5A17)

    def sample(logits, i):
        k = jax.random.fold_in(sample_key, i)
        if temperature <= 0:
            return jnp.argmax(logits, -1).astype(jnp.int32)
        return jax.random.categorical(k, logits / temperature).astype(
            jnp.int32)

    toks = sample(logits, 0)
    outs = [toks]
    for i in range(1, G):
        logits, cache = decode(params, cache, toks)
        toks = sample(logits, i)
        outs.append(toks)
    return np.asarray(prompts), np.asarray(jnp.stack(outs, axis=1))


def _args(B, P, G, temperature, seed=0):
    return argparse.Namespace(slots=B, prompt_len=P, gen_len=G,
                              temperature=temperature, seed=seed,
                              device="cpu")


def _seq_lines(out):
    return [ln for ln in out.splitlines() if ln.strip().startswith("seq")]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_lockstep_tokens_match_jax(capsys, arch, n_layers, temperature):
    jcfg, tcfg = configs(arch, n_layers)
    jp, tp = both_params(jcfg, tcfg, seed=1)
    B, P, G = 3, 48, 40
    if tcfg.family == "hybrid":
        assert api.decode_cache_len(tcfg, P + G) == tcfg.attn_window == 64
    want_prompts, want = jax_lockstep(jcfg, jp, B, P, G, temperature, seed=3)
    args = _args(B, P, G, temperature, seed=3)
    jax_serve._serve_lockstep(jcfg, jp, args)
    jax_lines = _seq_lines(capsys.readouterr().out)
    assert jax_lines == [f"  seq{b}: {list(map(int, want[b][:16]))}..."
                         for b in range(B)]
    run = port_serve._serve_lockstep(tcfg, api.prepare_params(tcfg, tp), args)
    assert _seq_lines(capsys.readouterr().out) == jax_lines
    np.testing.assert_array_equal(run.prompts, want_prompts)
    assert run.tokens.shape == (B, G) and run.tokens.dtype == np.int32
    np.testing.assert_array_equal(run.tokens, want)
    assert run.prefill_s > 0 and run.decode_s > 0


@pytest.mark.parametrize("vocab", [65536, 256000])
@pytest.mark.parametrize("seed", [0, 7])
def test_prompts_match_jax_randint_at_full_vocab(vocab, seed):
    """rwkv6-3b's and recurrentgemma-9b's vocabularies: the port draws the
    prompts `jax.random.randint` draws."""
    got = prng.randint(prng.prng_key(seed), (8, 128), 0, vocab)
    want = jax.random.randint(jax.random.PRNGKey(seed), (8, 128), 0, vocab)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serves_hybrid_checkpoint_written_by_jax_package(tmp_path):
    """A per-leaf param checkpoint of the 5-layer hybrid (its ``rem`` list
    included) from `repro.checkpoint` serves the JAX package's tokens."""
    jcfg, tcfg = configs("recurrentgemma_9b", 5)
    jp, _ = both_params(jcfg, tcfg, seed=4)
    ck = os.path.join(tmp_path, "hybrid.msgpack")
    save_pytree(ck, {"theta_g": jax.tree.map(np.asarray, jp)})
    _, want = jax_lockstep(jcfg, jax_serve.load_params(jcfg, ck), 2, 10, 6,
                           0.0, seed=0)
    params = port_serve.load_params(tcfg, ck, "cpu")
    assert len(params["rem"]) == 2
    run = port_serve._serve_lockstep(
        tcfg, api.prepare_params(tcfg, params, release=True),
        _args(2, 10, 6, 0.0))
    np.testing.assert_array_equal(run.tokens, want)
    # release=True gave the masters up as it cast them
    assert all(v is None for v in params.values())


@pytest.mark.parametrize("arch", ["rwkv6_3b", "recurrentgemma_9b"])
def test_lockstep_cli_runs_on_cpu(capsys, arch):
    argv = ["--device", "cpu", "--arch", arch, "--reduced", "--slots", "2",
            "--prompt-len", "6", "--gen-len", "5", "--temperature", "0.8"]
    assert port_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "prefill 2x6 tokens" in out and "decode 2x5 tokens" in out
    assert len(_seq_lines(out)) == 2
    run = port_serve.run(argv)
    assert isinstance(run, port_serve.LockstepRun)
    assert run.tokens.shape == (2, 5)
    assert ((run.tokens >= 0) & (run.tokens < 512)).all()


def test_prepare_params_keeps_only_the_compute_copy_and_f32_head():
    _, tcfg = configs("recurrentgemma_9b", 5, compute="bfloat16")
    params = api.init_params(tcfg, torch.Generator().manual_seed(0))
    head = params["lm_head"].clone()
    cp = api.prepare_params(tcfg, params)
    assert "lm_head" not in cp and cp["lm_head_f32"].dtype == torch.float32
    torch.testing.assert_close(cp["lm_head_f32"],
                               head.bfloat16().float(), rtol=0, atol=0)
    assert cp["rem"][0]["mixer"]["wa"].dtype == torch.bfloat16
    assert params["lm_head"] is not None        # not released by default
    f32 = dataclasses.replace(tcfg, compute_dtype="float32")
    masters = api.init_params(f32, torch.Generator().manual_seed(0))
    # at f32 compute the cast is the identity: no second copy
    assert api.prepare_params(f32, masters)["embed"] is masters["embed"]
