"""The training slice end to end against the JAX package: the regression
spec `experiments/specs/static4_paper.json` (bench_tiny, M=4, K=4, H=24,
tau=8, calibrated symmetric network), cut to 48 steps, through both
packages' `build_experiment`, from the same initial params, for every
method and both engine layouts.

Required: the eval records' steps and every `stats()` value identical (the
sync schedule, n_syncs, bytes_sent, the simulated wall_clock_s and
comm_seconds, ...), and train loss / eval NLL within 1e-5 relative (f32
compute; measured on this grid: at most ~1e-6). A run whose payload goes
through a discrete choice — bf16 rounding, top-k membership — is held to
1e-3 relative instead: an ulp-level f32 difference can move an element
across a rounding or top-k boundary, and that difference then compounds
(measured: 7.4e-5 with bf16 top-k-0.5 payloads, test_torch_train_cli.py).
The JAX side runs its
per-step loop (`run.loop` is outside `spec_hash`; the JAX package pins it
bitwise to its segment loop), which compiles less; the port runs its
event-driven loop.

This file covers the overlapped methods; test_torch_train_e2e_blocking.py
covers diloco and local.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import ExperimentSpec as JaxSpec  # noqa: E402
from repro.api import build_experiment as jax_build  # noqa: E402
from repro_torch.api import ExperimentSpec, build_experiment  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPEC = Path(__file__).resolve().parents[1] / "experiments" / "specs" / \
    "static4_paper.json"
LOSS_RTOL = 1e-5
DISCRETE_PAYLOAD_RTOL = 1e-3
VALUES = ("train_loss", "nll", "ppl")


def run_pair(method: str, fused: bool, extensions=None, network=None):
    d = json.loads(SPEC.read_text())
    d["run"]["steps"] = 48
    d["method"]["name"] = method
    d["method"]["extensions"]["fused_updates"] = fused
    d["method"]["extensions"].update(extensions or {})
    d["network"].update(network or {})
    spec = ExperimentSpec.from_dict(d)
    jspec = JaxSpec.from_dict({**d, "run": {**d["run"], "loop": "per_step"}})
    assert jspec.spec_hash == spec.spec_hash
    jt = jax_build(jspec)
    params = jax.tree.map(lambda a: np.asarray(a[0]), jt.params_stack)
    jh = jt.run(eval_every=jspec.run.eval_every)
    th = build_experiment(spec, device="cpu", params=params).run(
        eval_every=spec.run.eval_every)
    return jh, th


def check_pair(jh, th, rtol=LOSS_RTOL):
    assert [r["step"] for r in th] == [r["step"] for r in jh] == [16, 32, 48]
    worst = 0.0
    for a, b in zip(th, jh):
        assert {k: v for k, v in a.items() if k not in VALUES} == \
            {k: v for k, v in b.items() if k not in VALUES}
        for k in VALUES:
            worst = max(worst, abs(a[k] - b[k]) / abs(b[k]))
    assert worst <= rtol, worst
    return worst


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", ["cocodc", "streaming"])
def test_static4_paper_matches_jax(method, fused):
    jh, th = run_pair(method, fused)
    check_pair(jh, th)
    assert th[-1]["n_syncs"] > 0
