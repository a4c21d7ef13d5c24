"""The port's serving slice held against the JAX package's: the same trace
through both `ServeEngine`s gives the same greedy tokens and the same stats
(everything but the host clock's ``wall_s``), in continuous and static modes,
greedy and sampled at temperature 0.8 (the same threefry keys and Gumbel
draw); checkpoints written by `repro.checkpoint` serve the same tokens, and
a fused-mode training checkpoint unpacks to the params the JAX package's
`_unflatten_theta` gives; the CLI runs; and the port imports nothing of JAX
or of the JAX package.

Token identity is checked at f32 compute (bench_tiny natively, qwen3-0.6b
reduced with compute_dtype replaced); bf16 logits are held to a tolerance in
test_torch_models.py.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import save_pytree  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _trace(n, vocab, seed=0, pmax=14, gmax=12):
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(1 / 8.0))
        P = int(rng.integers(3, pmax + 1))
        out.append(dict(rid=i, prompt=rng.integers(0, vocab, size=P)
                        .astype(np.int32),
                        max_new_tokens=int(rng.integers(2, gmax + 1)),
                        arrival_s=t))
    return out


def _configs(arch, reduced=False):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, compute_dtype="float32")
    return jcfg, tcfg


def _run_both(jcfg, tcfg, jp, tp, trace, **kw):
    jeng = JaxEngine(jcfg, jp, attn_impl="ref", **kw)
    jrecs = jeng.run_trace([JaxRequest(**r) for r in trace])
    teng = ServeEngine(tcfg, tp, device="cpu", **kw)
    trecs = teng.run_trace([Request(**r) for r in trace])
    return jeng, jrecs, teng, trecs


@pytest.mark.parametrize("arch,reduced,mode", [
    ("bench_tiny", False, "continuous"),
    ("bench_tiny", False, "static"),
    ("qwen3_0_6b", True, "continuous"),
])
def test_engine_matches_jax_engine(arch, reduced, mode):
    jcfg, tcfg = _configs(arch, reduced)
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    trace = _trace(7, jcfg.vocab, seed=3)
    jeng, jrecs, teng, trecs = _run_both(
        jcfg, tcfg, jp, tp, trace, n_slots=3, cache_len=32, max_prompt=14,
        prefill_chunk=5, mode=mode)
    assert [(r.rid, r.slot, r.tokens) for r in trecs] == \
        [(r.rid, r.slot, r.tokens) for r in jrecs]
    js, ts = jeng.stats(), teng.stats()
    js.pop("wall_s")
    assert ts.pop("wall_s") > 0
    assert ts == js
    # on the CPU every kernel wrapper took its plain version: no launches
    assert teng.kernel_launches() == {"flash_decode": 0, "rms_norm": 0}


def test_sampling_streams_distinct_and_deterministic():
    """Same prompt, different request ids -> different samples; same engine
    seed + trace -> identical samples; another seed -> other samples."""
    cfg = get_config("bench_tiny")
    params = port_serve.load_params(cfg, None, "cpu")
    prompt = np.arange(2, 12, dtype=np.int32)
    reqs = [Request(rid=i, prompt=prompt, max_new_tokens=12) for i in (0, 1)]

    def run(seed):
        eng = ServeEngine(cfg, params, n_slots=2, cache_len=32, max_prompt=12,
                          prefill_chunk=6, temperature=1.0, seed=seed,
                          device="cpu")
        return {r.rid: r.tokens for r in eng.run_trace(list(reqs))}

    a, b = run(7), run(7)
    assert a == b
    assert a[0] != a[1]
    assert run(8) != a


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_sampling_matches_jax_engine_at_temperature(mode):
    """At temperature 0.8 both engines draw from the same keys
    (fold_in(fold_in(PRNGKey(seed), rid), position)) and the same Gumbel
    noise: identical tokens on the same params, trace and seed."""
    jcfg, tcfg = _configs("bench_tiny")
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    trace = _trace(7, jcfg.vocab, seed=3)
    jeng, jrecs, teng, trecs = _run_both(
        jcfg, tcfg, jp, tp, trace, n_slots=3, cache_len=32, max_prompt=14,
        prefill_chunk=5, mode=mode, temperature=0.8, seed=11)
    want = [(r.rid, r.tokens) for r in jrecs]
    assert [(r.rid, r.tokens) for r in trecs] == want
    # sampled, not greedy: some token differs from the argmax run
    greedy = ServeEngine(tcfg, tp, device="cpu", n_slots=3, cache_len=32,
                         max_prompt=14, prefill_chunk=5, mode=mode)
    assert [(r.rid, r.tokens) for r in greedy.run_trace(
        [Request(**r) for r in trace])] != want


def test_fused_checkpoint_params_match_jax_unflatten(tmp_path):
    """theta_g of a fused-mode training checkpoint (one flat fragment
    plane) unpacks to the JAX package's `_unflatten_theta` params and to the
    trainer's consensus model, and serves."""
    from repro.launch.serve import _unflatten_theta
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.launch import train
    ck = os.path.join(tmp_path, "fused.msgpack")
    tr = train.run(["--device", "cpu", "--arch", "bench_tiny", "--method",
                    "cocodc", "--fused-updates", "--wire-codec", "int8",
                    "--fragments", "3", "--fragment-strategy", "skewed",
                    "--steps", "8", "--H", "8", "--tau", "2",
                    "--local-batch", "2", "--seq-len", "16",
                    "--eval-every", "8", "--ckpt", ck])
    st = port_serve.load_pytree(ck)
    tcfg = get_config("bench_tiny")
    mine = port_serve.unflatten_theta(
        tcfg, st["trainer_state"]["engine"]["theta_g"], st["meta"])
    theirs = _unflatten_theta(jax_config("bench_tiny"),
                              st["trainer_state"]["engine"]["theta_g"],
                              st["meta"])
    got = leaves_with_path(mine)
    want = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(got) == len(want) == len(leaves_with_path(tr.engine.theta_g))
    for (_, a), (_, b), (_, c) in zip(got, want,
                                      leaves_with_path(tr.engine.theta_g)):
        assert np.array_equal(a, np.asarray(b))
        assert np.array_equal(a, c.numpy())
    params = port_serve.load_params(tcfg, ck, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(params), leaves_with_path(tr.engine.theta_g)))
    eng = port_serve.run(["--device", "cpu", "--arch", "bench_tiny", "--ckpt",
                          ck, "--requests", "3", "--prompt-len", "12",
                          "--gen-len", "6", "--temperature", "0.8"])
    assert eng.stats()["completed"] == 3


def test_serves_checkpoint_written_by_jax_package(tmp_path):
    """A param checkpoint from `repro.checkpoint` serves the same tokens in
    both packages; a fused-mode checkpoint whose plane does not fit the
    arch is refused, not misread."""
    from repro.launch.serve import load_params as jax_load_params
    jcfg, tcfg = _configs("bench_tiny")
    jp = jax_api.init_params(jcfg, jax.random.PRNGKey(5))
    ck = os.path.join(tmp_path, "params.msgpack")
    save_pytree(ck, {"theta_g": jp})
    trace = _trace(4, jcfg.vocab, seed=9)
    kw = dict(n_slots=2, cache_len=32, max_prompt=14, prefill_chunk=8)
    jeng = JaxEngine(jcfg, jax_load_params(jcfg, ck), attn_impl="ref", **kw)
    want = [r.tokens for r in jeng.run_trace([JaxRequest(**r)
                                              for r in trace])]
    teng = ServeEngine(tcfg, port_serve.load_params(tcfg, ck, "cpu"),
                       device="cpu", **kw)
    assert [r.tokens for r in teng.run_trace([Request(**r)
                                              for r in trace])] == want

    fused = os.path.join(tmp_path, "fused.msgpack")
    save_pytree(fused, {"format": "trainer_state_v1",
                        "meta": {"arch": tcfg.name, "fused_updates": True},
                        "trainer_state": {"engine": {
                            "theta_g": np.zeros((4, 1024), np.float32)}}})
    with pytest.raises(ValueError, match="checkpoint/arch mismatch"):
        port_serve.load_params(tcfg, fused, "cpu")


def test_cli_runs_on_cpu(capsys):
    assert port_serve.main(["--device", "cpu", "--arch", "bench_tiny",
                            "--requests", "5", "--slots", "3",
                            "--prompt-len", "12", "--gen-len", "6",
                            "--prefill-chunk", "4", "--mode", "static"]) == 0
    out = capsys.readouterr().out
    assert "completed=5/5" in out and "device=cpu" in out


def test_entry_points_never_drift_to_cpu():
    """No device given: CUDA, or an error when there is none."""
    if torch.cuda.is_available():
        assert kernels.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            kernels.resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_serve.main(["--arch", "bench_tiny", "--requests", "1"])


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"
