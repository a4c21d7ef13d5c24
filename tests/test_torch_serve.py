"""The port's serving slice held against the JAX package's: the same trace
through both `ServeEngine`s gives the same greedy tokens and the same stats
(everything but the host clock's ``wall_s``), in continuous and static modes;
checkpoints written by `repro.checkpoint` serve the same tokens; the CLI
runs; and the port imports nothing of JAX or of the JAX package.

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


def test_serves_checkpoint_written_by_jax_package(tmp_path):
    """A param checkpoint from `repro.checkpoint` serves the same tokens in
    both packages; a fused-mode checkpoint is refused, not misread."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
