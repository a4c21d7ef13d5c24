"""The port's training CLI, spec and network layers against the JAX
package's: the same `--print-spec` JSON and `spec_hash` for the same flags,
`--spec` round trips, a CPU smoke run, the static network's costs copied to
the bit, a run with every protocol extension of the slice on a
heterogeneous network matching the JAX run, a compressed run paused with
--stop-at and continued with --resume replaying the uninterrupted run, and
every option outside the port raising NotImplementedError (never a silent
fallback)."""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import ExperimentSpec as JaxSpec  # noqa: E402
from repro.core import network as jax_net  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro_torch.api import ExperimentSpec, build_experiment  # noqa: E402
from repro_torch.core import network as net  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from test_torch_train_e2e import (DISCRETE_PAYLOAD_RTOL, check_pair,  # noqa: E402
                                  run_pair)
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLAGS = ["--arch", "bench_tiny", "--method", "streaming", "--workers", "3",
         "--fragments", "3", "--H", "12", "--tau", "4", "--steps", "6",
         "--local-batch", "2", "--seq-len", "16", "--eval-every", "3",
         "--fused-updates", "--fragment-strategy", "skewed",
         "--topology", "hub_spoke", "--lr", "3e-3"]


def test_print_spec_and_hash_match_jax(capsys, tmp_path):
    assert train.main(FLAGS + ["--print-spec"]) == 0
    ours = capsys.readouterr().out
    assert jax_train.main(FLAGS + ["--print-spec"]) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs
    spec = ExperimentSpec.from_json(ours)
    assert spec.spec_hash == JaxSpec.from_json(theirs).spec_hash
    path = tmp_path / "spec.json"
    spec.save(str(path))
    assert train.main(["--spec", str(path), "--print-spec"]) == 0
    assert ExperimentSpec.from_json(capsys.readouterr().out) == spec
    # explicit flags override the file
    assert train.main(["--spec", str(path), "--method", "cocodc",
                       "--print-spec"]) == 0
    assert json.loads(capsys.readouterr().out)["method"]["name"] == "cocodc"


def test_cli_trains_on_cpu(capsys, tmp_path):
    out = tmp_path / "hist.json"
    tr = train.run(FLAGS + ["--device", "cpu", "--history-out", str(out)])
    assert [r["step"] for r in tr.history] == [3, 6]
    assert all(np.isfinite(r["nll"]) for r in tr.history)
    assert tr.engine.stats()["n_syncs"] > 0
    assert "busiest link" in capsys.readouterr().out
    assert json.loads(out.read_text())["history"][-1]["step"] == 6


def test_cli_needs_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run(FLAGS)


@pytest.mark.parametrize("flags", [
    ["--dynamics", "diurnal"],
    ["--mesh", "ring"],
    ["--topology", "asym4", "--routing", "routed"],
    ["--channel-scheduler", "fairshare"],
    ["--arch", "rwkv6_3b", "--reduced"],
    ["--arch", "recurrentgemma_9b", "--reduced"],
])
def test_out_of_scope_options_raise(flags):
    base = ["--arch", "bench_tiny", "--workers", "4", "--steps", "2",
            "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train.run(base + flags)


def test_cli_stop_and_resume_with_codec(tmp_path, capsys):
    """`--wire-codec int8 --ckpt f --stop-at 12`, then `--resume f`: the
    resumed run ends where the uninterrupted run ends, bitwise; `--ckpt-every`
    without `--ckpt` is refused."""
    flags = FLAGS + ["--device", "cpu", "--wire-codec", "int8", "--steps",
                     "24", "--eval-every", "6"]
    ck = str(tmp_path / "run.msgpack")
    full = train.run(flags)
    half = train.run(flags + ["--stop-at", "12", "--ckpt", ck])
    assert half.step == 12
    assert "checkpoint (full run state, step 12)" in capsys.readouterr().out
    rest = train.run(flags + ["--resume", ck])
    assert rest.history == full.history
    assert rest.engine.stats()["compression_ratio"] > 3.9
    got, want = (leaves_with_path(t.params_stack) for t in (rest, full))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    with pytest.raises(SystemExit):
        train.run(flags + ["--ckpt-every", "6"])


def test_cli_resumes_legacy_theta_checkpoint(tmp_path):
    """A legacy dict of theta_g and the outer momentum restores the
    consensus model and momentum, and every worker restarts from it."""
    from repro_torch.checkpoint import save_pytree
    flags = FLAGS + ["--device", "cpu", "--steps", "3"]
    src = train.run(flags)
    ck = str(tmp_path / "legacy.msgpack")
    save_pytree(ck, {"theta_g": src.engine.theta_g,
                     "momentum": src.engine.momentum, "step": 3})
    tr = build_experiment(src.spec, device="cpu")
    train.resume(tr, ck)
    want = leaves_with_path(src.engine.theta_g)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(tr.engine.theta_g), want))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(tr.engine.momentum),
        leaves_with_path(src.engine.momentum)))
    for (_, stack), (_, g) in zip(leaves_with_path(tr.params_stack), want):
        assert all(torch.equal(w, g) for w in stack)


@pytest.mark.parametrize("name", ["paper", "asym4", "hub_spoke",
                                  "transpacific_flaky"])
def test_static_network_costs_bitwise(name):
    """Topologies, collective costs and per-link accounting equal the JAX
    package's to the bit (the simulated clock is built from them)."""
    a = net.make_scenario(name, num_workers=4, step_time_s=0.7)
    b = jax_net.make_scenario(name, num_workers=4, step_time_s=0.7)
    assert a.regions == b.regions and a.collective == b.collective
    for nbytes in (0, 123_457, 134_105_856):
        assert a.t_s(nbytes) == b.t_s(nbytes)
        assert a.tau_steps(nbytes) == b.tau_steps(nbytes)
        assert np.array_equal(a.link_seconds(nbytes), b.link_seconds(nbytes))
        assert np.array_equal(a.link_bytes(nbytes), b.link_bytes(nbytes))
    assert net.calibrate_bw_scale(a, 1 << 20) == \
        jax_net.calibrate_bw_scale(b, 1 << 20)
    p = net.paper_network(4, fragment_bytes=4_000_000, tau=8)
    q = jax_net.paper_network(4, fragment_bytes=4_000_000, tau=8)
    assert (p.latency_s, p.bandwidth_Bps, p.step_time_s) == \
        (q.latency_s, q.bandwidth_Bps, q.step_time_s)


def test_auto_bw_scale_and_channels_build():
    spec = ExperimentSpec.from_dict({
        "model": {"arch": "bench_tiny"},
        "method": {"name": "cocodc", "num_workers": 4, "local_steps": 12},
        "network": {"topology": "asym4", "bw_scale": "auto",
                    "concurrent_collectives": 2},
        "run": {"steps": 2, "local_batch": 1, "seq_len": 8}})
    jspec = JaxSpec.from_dict(spec.to_dict())
    from repro.api import build_network as jax_build_network
    from repro_torch.api import build_network
    a, b = build_network(spec), jax_build_network(jspec)
    assert np.array_equal(a.bandwidth_Bps, b.bandwidth_Bps)
    assert a.concurrent_collectives == b.concurrent_collectives == 2
    tr = build_experiment(spec, device="cpu")
    tr.run(eval_every=2)
    assert tr.history[-1]["step"] == 2


def test_static4_extensions_on_asym4_match_jax():
    """Link pricing, Eq. 9 re-derivation, skewed fragments, bf16 top-k
    payloads and two WAN channels on the 4-region asymmetric mesh."""
    jh, th = run_pair(
        "cocodc", False,
        extensions={"link_pricing": True, "adaptive_resync": True,
                    "fragment_strategy": "skewed", "sync_dtype": "bfloat16",
                    "sync_topk_frac": 0.5},
        network={"topology": "asym4", "bw_scale": "auto",
                 "concurrent_collectives": 2})
    check_pair(jh, th, rtol=DISCRETE_PAYLOAD_RTOL)
    # bf16 halves the wire; top-k 0.5 ships values + indices: ratio 2
    assert th[-1]["n_syncs"] > 0 and th[-1]["compression_ratio"] == 2.0


@pytest.mark.parametrize("method", ["cocodc", "streaming"])
def test_per_step_loop_equals_segment_loop(method):
    """`--loop per_step` runs the event-driven loop in one-step segments, so
    the engine's hook sees every step; it gives the segment loop's history
    (losses, evals, stats) and params exactly, and so do repeated
    `train_one_step` calls."""
    flags = [method if f == "streaming" else f for f in FLAGS]
    flags += ["--steps", "12", "--H", "6", "--device", "cpu"]
    seg = train.run(flags + ["--loop", "segment"])
    per = train.run(flags + ["--loop", "per_step"])
    assert seg.history[-1]["n_syncs"] > 0
    assert per.history == seg.history
    one = build_experiment(seg.spec, device="cpu")
    for _ in range(12):
        one.train_one_step()
    assert one.engine.stats() == seg.engine.stats()
    want = leaves_with_path(seg.params_stack)
    for tr in (per, one):
        got = leaves_with_path(tr.params_stack)
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
