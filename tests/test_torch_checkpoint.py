"""Checkpoint writing and resume in the port, held against the JAX
package's format and trajectories:

  * the msgpack format: a save/load round trip with bf16 leaves, files of
    either package read by the other, `restore_like` refusing a structure
    or shape mismatch;
  * kill at step 26 of `static4_paper` (48 steps), with a transfer in
    flight (its transfers take 2-3 steps), then resume to 48: bitwise equal
    to the uninterrupted run (which lacks only the killed run's eval at the
    stop), for cocodc fused + int8 + error feedback and for streaming
    per-leaf + int4;
  * a checkpoint written by the JAX trainer at step 26 resumed in the port
    to 48 matches JAX's uninterrupted run (stats identical, losses within
    1e-3 relative: the codec's discrete payload, test_torch_train_e2e.py),
    and the port's re-save of it resumes in JAX bitwise;
  * resume refused on a codec or spec mismatch, naming the field;
  * a v4 scheduler dict upgraded to v6 as the JAX package upgrades it, and
    a scheduler dict of a run that used features the port lacks refused.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import ExperimentSpec as JaxSpec  # noqa: E402
from repro.api import build_experiment as jax_build  # noqa: E402
from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.core.protocol import upgrade_scheduler_state as jax_upgrade  # noqa: E402
from repro_torch.api import ExperimentSpec, build_experiment  # noqa: E402
from repro_torch.checkpoint import (load_pytree, restore_like,  # noqa: E402
                                    save_pytree)
from repro_torch.core import engine_state as es  # noqa: E402
from repro_torch.core.protocol import upgrade_scheduler_state  # noqa: E402
from repro_torch.core.trainer import CrossRegionTrainer  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401
from test_torch_train_e2e import (DISCRETE_PAYLOAD_RTOL, SPEC,  # noqa: E402
                                  check_pair)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KILL = 26          # a step of static4_paper with a transfer in flight


def _spec_dict(method="cocodc", fused=True, codec="int8", steps=48, **ext):
    d = json.loads(SPEC.read_text())
    d["run"]["steps"] = steps
    d["method"]["name"] = method
    d["method"]["extensions"].update(fused_updates=fused, wire_codec=codec,
                                     **ext)
    return d


def _without_kill_eval(history):
    """The history less the eval a run records where it stops at KILL."""
    return [r for r in history if r["step"] != KILL]


def _tree_equal(a, b) -> bool:
    la, lb = leaves_with_path(a), leaves_with_path(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        (x is None and y is None) or torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


def _engine_equal(a: es.EngineState, b: es.EngineState) -> bool:
    for f in dataclasses.fields(es.EngineState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None):
            return False
        if x is None:
            continue
        if not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else _tree_equal(x, y)):
            return False
    return True


def test_save_load_roundtrip_and_cross_package_format(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    tree = {"b": {"w_bf16": w.to(torch.bfloat16), "w": w,
                  "count": torch.arange(4, dtype=torch.int32),
                  "mask": torch.tensor([True, False])},
            "a": None, "hist": [{"step": 3, "nll": 1.25}],
            "links": np.eye(2), "x": 7, "name": "run"}
    path = os.path.join(tmp_path, "t.msgpack")
    save_pytree(path, tree)
    back = load_pytree(path)
    assert back["a"] is None and back["x"] == 7 and back["name"] == "run"
    assert back["hist"] == [{"step": 3, "nll": 1.25}]
    assert back["b"]["w_bf16"].dtype == np.float32     # stored widened
    restored = restore_like(tree["b"], back["b"])
    assert restored["w_bf16"].dtype == torch.bfloat16
    assert _tree_equal(restored, tree["b"])
    assert np.array_equal(back["links"], np.eye(2))
    # the JAX package reads the port's file (bf16 comes back as bf16)...
    theirs = jax_load(path)
    assert theirs["b"]["w_bf16"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(theirs["b"]["w_bf16"], np.float32),
                          tree["b"]["w_bf16"].float().numpy())
    assert np.array_equal(theirs["b"]["count"], np.arange(4))
    # the same tree written by both packages gives the same bytes (large
    # arrays take the port's direct path, small ones msgpack's)
    big = rng.standard_normal((70, 1000)).astype(np.float32)
    mine = {"big": torch.from_numpy(big), "big_t": torch.from_numpy(big).T,
            "bf": torch.from_numpy(big).to(torch.bfloat16), "w": w,
            "s": torch.tensor(2.5), "n": np.float32(1.5), "none": None,
            "rows": [1, 2.0, "x"]}
    theirs = {"big": big, "big_t": big.T, "w": w.numpy(), "s": np.float32(2.5),
              "bf": jnp.asarray(big, jnp.bfloat16), "n": np.float32(1.5),
              "none": None, "rows": [1, 2.0, "x"]}
    save_pytree(path, mine)
    jax_save(os.path.join(tmp_path, "same.msgpack"), theirs)
    with open(path, "rb") as a, open(os.path.join(tmp_path, "same.msgpack"),
                                     "rb") as b:
        assert a.read() == b.read()
    # ... and the port reads the JAX package's
    jpath = os.path.join(tmp_path, "j.msgpack")
    jax_save(jpath, {"b": {"w_bf16": jnp.asarray(w.numpy(), jnp.bfloat16),
                           "w": jnp.asarray(w.numpy())}, "a": None})
    mine = load_pytree(jpath)
    restored = restore_like({"w_bf16": tree["b"]["w_bf16"], "w": w},
                            mine["b"])
    assert torch.equal(restored["w_bf16"], tree["b"]["w_bf16"])
    assert torch.equal(restored["w"], w)


def test_restore_like_rejects_structure_mismatch():
    ref = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}}
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_like(ref, {"a": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_like(ref, {"a": np.zeros((3, 2), np.float32),
                           "b": {"c": np.zeros(4, np.float32)}})
    out = restore_like(ref, {"a": np.ones((2, 3)), "b": {"c": np.ones(4)}})
    assert out["a"].dtype == torch.float32 and out["b"]["c"].sum() == 4


@pytest.mark.parametrize("method,fused,codec", [("cocodc", True, "int8"),
                                                ("streaming", False, "int4")])
def test_kill_and_resume_replays_the_run_bitwise(tmp_path, method, fused,
                                                 codec):
    spec = ExperimentSpec.from_dict(_spec_dict(method, fused, codec))
    full = build_experiment(spec, device="cpu")
    full.run(eval_every=spec.run.eval_every)
    ck = os.path.join(tmp_path, "ck.msgpack")
    killed = build_experiment(spec, device="cpu")
    killed.run(steps=KILL, eval_every=spec.run.eval_every)
    assert killed.engine.pending                  # transfers in flight
    assert killed.engine.state.wire_residual is not None
    killed.save_checkpoint(ck)
    del killed
    resumed = build_experiment(spec, device="cpu").restore_checkpoint(ck)
    assert resumed.step == KILL
    resumed.run(eval_every=spec.run.eval_every)
    assert _without_kill_eval(resumed.history) == full.history
    assert resumed.engine.stats() == full.engine.stats()
    assert _tree_equal(resumed.params_stack, full.params_stack)
    assert _tree_equal(resumed.opt_state.mu, full.opt_state.mu)
    assert _engine_equal(resumed.engine.state, full.engine.state)


def test_resumes_checkpoint_written_by_jax_trainer(tmp_path):
    d = _spec_dict("cocodc", True, "int8")
    spec = ExperimentSpec.from_dict(d)
    jspec = JaxSpec.from_dict({**d, "run": {**d["run"], "loop": "per_step"}})
    jck = os.path.join(tmp_path, "jax.msgpack")
    jt = jax_build(jspec)
    jt.run(steps=KILL, eval_every=jspec.run.eval_every)
    assert jt.engine.pending
    jt.save_checkpoint(jck)
    jh = jt.run(eval_every=jspec.run.eval_every)      # the uninterrupted run

    tr = build_experiment(spec, device="cpu").restore_checkpoint(jck)
    assert tr.step == KILL and tr.engine.pending
    # the port's re-save of the JAX state resumes in JAX bitwise
    pck = os.path.join(tmp_path, "port.msgpack")
    tr.save_checkpoint(pck)
    jt2 = jax_build(jspec).restore_checkpoint(pck)
    assert jt2.run(eval_every=jspec.run.eval_every) == jh

    th = tr.run(eval_every=spec.run.eval_every)
    check_pair(_without_kill_eval(jh), _without_kill_eval(th),
               rtol=DISCRETE_PAYLOAD_RTOL)
    assert th[-1]["compression_ratio"] > 3.9


def test_resume_rejects_codec_or_spec_mismatch(tmp_path):
    d = _spec_dict("cocodc", True, "int8", steps=4)
    d["run"].update(local_batch=1, seq_len=8)
    tr = build_experiment(ExperimentSpec.from_dict(d), device="cpu")
    tr.run(eval_every=4)
    ck = os.path.join(tmp_path, "ck.msgpack")
    tr.save_checkpoint(ck)
    other = json.loads(json.dumps(d))
    other["method"]["extensions"]["wire_codec"] = "int4"
    with pytest.raises(ValueError, match="extensions.wire_codec"):
        build_experiment(ExperimentSpec.from_dict(other),
                         device="cpu").restore_checkpoint(ck)
    other = json.loads(json.dumps(d))
    other["run"]["seed"] = 5
    with pytest.raises(ValueError, match="run.seed"):
        build_experiment(ExperimentSpec.from_dict(other),
                         device="cpu").restore_checkpoint(ck)
    # a trainer built without a spec compares the trajectory meta by key
    bare = CrossRegionTrainer(
        tr.mcfg, dataclasses.replace(tr.ccfg, wire_codec="int4"), tr.tcfg,
        device="cpu")
    with pytest.raises(ValueError, match="wire_codec"):
        bare.restore_checkpoint(ck)
    same = CrossRegionTrainer(tr.mcfg, tr.ccfg, tr.tcfg, device="cpu")
    assert same.restore_checkpoint(ck).step == 4


def _scheduler_after(steps=KILL, **ext):
    d = _spec_dict("cocodc", False, "int8", steps=steps, **ext)
    d["run"].update(local_batch=1, seq_len=8)
    tr = build_experiment(ExperimentSpec.from_dict(d), device="cpu")
    tr.run(eval_every=steps)
    return tr


def test_v4_scheduler_dict_upgrades_to_v6_as_jax_does():
    tr = _scheduler_after(adaptive_resync=True)
    st = tr.engine.scheduler_state()
    assert st["schema_version"] == 6 and st["pending"]
    legacy = {k: v for k, v in st.items()
              if k not in ("wire_bytes_raw", "multipath_splits",
                           "transfer_log", "fairshare")}
    legacy["schema_version"] = 4
    legacy["pending"] = [r[:6] for r in st["pending"]]
    legacy["resync"] = {k: v for k, v in st["resync"].items()
                        if k != "measured_bytes"}
    up = upgrade_scheduler_state(legacy)
    assert up == jax_upgrade(legacy)
    assert up["schema_version"] == 6
    assert up["wire_bytes_raw"] == st["bytes_sent"]
    assert all(len(r) == 8 and r[7] == -1 for r in up["pending"])
    assert up["resync"]["measured_bytes"] == [0.0] * len(
        st["resync"]["measured"])
    tr.engine.restore_scheduler(legacy)
    s = tr.engine.stats()
    assert s["compression_ratio"] == 1.0 and s["n_syncs"] == st["n_syncs"]
    # the current schema round-trips unchanged
    assert upgrade_scheduler_state(st) == jax_upgrade(st)


@pytest.mark.parametrize("field,value", [
    ("dyn_seq", 3), ("fairshare", {"flows": []}), ("multipath_splits", 1),
    ("routing", {"plan_time": 12.5})])
def test_restore_refuses_state_of_unported_network_features(field, value):
    tr = _scheduler_after(steps=8)
    st = tr.engine.scheduler_state()
    st[field] = {**st["routing"], **value} if field == "routing" else value
    with pytest.raises(NotImplementedError, match="Queue A"):
        tr.engine.restore_scheduler(st)
