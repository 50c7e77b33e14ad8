"""Checkpoints and bit-exact stop/resume on the port (mirrors the resume,
checkpointer and Experiment rows of ``tests/test_chaos.py``).

The port's contract is the reference's: a run cut at a slow-period
boundary and resumed from its snapshot ends in the same state, to the
bit, as the uninterrupted run, on the per-tick and the mega paths.  Its
generator's position travels in the snapshot.  A reference chunk's state
and snapshot also carry across into the port, which then finishes the
run as the reference does.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.api import engine as ref_engine
from repro.envsim import SimConfig as RefSimConfig
from repro.envsim import batched as ref_batched
from repro.envsim import scenarios as ref_scen
from repro_torch import api
from repro_torch.api import engine, experiment
from repro_torch.checkpoint import Checkpointer, CorruptCheckpointError
from repro_torch.core import fleet, generative
from repro_torch.envsim import SimConfig, batched, scenarios
from torch_port_ref import (JaxChainNoise, assert_bits_equal, assert_close,
                            assert_tree_close, mega_state_to_port,
                            snapshot_to_port, t2n, to_numpy)

R, T = 4, 40


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def _world(scenario, r=R, t=T):
    sc = scenarios.build_scenario(scenario, SimConfig(), r, t)
    params = batched.params_from_config(SimConfig(), r, sc.capacity_scale,
                                        device="cpu")
    return params, batched.make_scenario_env_step(params, sc)


def _cat(a, b):
    return experiment._cat([a, b])


# ----------------------------------------------------- stop/resume bit-parity
ROUTERS = {"aif-fused": api.AifRouter(),
           "aif-unfused": api.AifRouter(fused=False),
           "thompson": api.ThompsonRouter()}


@pytest.mark.parametrize("name", sorted(ROUTERS))
def test_resume_bit_identical_per_tick(name):
    router = ROUTERS[name]
    params, env_step = _world("zone-outage")
    c_u, e_u, tr_u = engine.rollout(router, router.init_carry(R, "cpu"),
                                    batched.init_fluid_state(params),
                                    env_step, T, seed=42)
    c1, e1, tr1, snap = engine.resumable_rollout(
        router, router.init_carry(R, "cpu"), batched.init_fluid_state(params),
        env_step, 20, seed=42)
    assert snap[1].dtype == torch.uint8      # the generator's position
    c2, e2, tr2, _ = engine.resumable_rollout(
        router, c1, e1, env_step, 20, seed=42, t_begin=20, snapshot=snap)
    assert_bits_equal(c_u, c2)
    assert_bits_equal(e_u, e2)
    assert_bits_equal(tr_u, _cat(tr1, tr2))


def test_resume_bit_identical_mega():
    router = api.AifRouter(mega=True)
    params, env_step = _world("paper-burst")
    c_u, e_u, tr_u = engine.rollout(router, None,
                                    batched.init_fluid_state(params),
                                    env_step, T, seed=42)
    c1, e1, tr1, snap = engine.resumable_rollout(
        router, None, batched.init_fluid_state(params), env_step, 20,
        seed=42, n_total=T)
    c2, e2, tr2, _ = engine.resumable_rollout(
        router, c1, e1, env_step, 20, seed=42, t_begin=20, snapshot=snap)
    assert_bits_equal(c_u, c2)
    assert_bits_equal(e_u, e2)
    assert_bits_equal(tr_u, _cat(tr1, tr2))


def _ref_world(scenario):
    sc = ref_scen.build_scenario(scenario, RefSimConfig(), R, T)
    params = ref_batched.params_from_config(RefSimConfig(), R,
                                            sc.capacity_scale)
    return params, ref_batched.make_scenario_env_step(params, sc)


@pytest.mark.parametrize("mega", [False, True], ids=["per-tick", "mega"])
def test_reference_chunk_resumes_on_the_port(mega):
    """The reference's first chunk, carried across (router carry, env
    state, snapshot), finishes on the port as on the reference."""
    scenario = "paper-burst" if mega else "zone-outage"
    key = jax.random.key(42)
    params_r, env_r = _ref_world(scenario)
    ref_router = ref_api.AifRouter(fused=True, mega=mega)
    c1, e1, _, snap = ref_engine.resumable_rollout(
        ref_router, None if mega else ref_router.init_carry(R),
        ref_batched.init_fluid_state(params_r), env_r, 20, key,
        n_total=T if mega else None)
    c1_np, e1_np = to_numpy(c1), to_numpy(e1)
    snap_p = snapshot_to_port(jax.device_get(snap))
    c2, e2, tr2, _ = ref_engine.resumable_rollout(
        ref_router, c1, e1, env_r, 20, key, t_begin=20, snapshot=snap)

    router = api.AifRouter(mega=mega)
    carry = (mega_state_to_port(c1_np, router.cfg) if mega else
             fleet.agent_state_from_numpy(c1_np, router.cfg, "cpu"))
    _, env_p = _world(scenario)
    p2, pe2, ptr2, _ = engine.resumable_rollout(
        router, carry, batched.fluid_state_from_numpy(e1_np, "cpu"), env_p,
        20, JaxChainNoise(42, R, T), t_begin=20, snapshot=snap_p)
    np.testing.assert_array_equal(t2n(ptr2.actions), np.asarray(tr2.actions))
    assert_tree_close(pe2, e2)
    assert_close(p2.belief, c2.belief)
    assert_tree_close(ptr2.env, tr2.env)


def test_resume_boundary_validation():
    router = api.AifRouter()
    params, env_step = _world("paper-burst")
    args = (router, router.init_carry(R, "cpu"),
            batched.init_fluid_state(params), env_step, 10)
    with pytest.raises(ValueError, match="boundary"):
        engine.resumable_rollout(*args, t_begin=7, snapshot=((), None))
    with pytest.raises(ValueError, match="snapshot"):
        engine.resumable_rollout(*args, t_begin=20, snapshot=None)
    with pytest.raises(ValueError, match="snapshot"):
        engine.resumable_rollout(*args, t_begin=0, snapshot=((), None))


# ----------------------------------------------------- checkpointer hardening
LIKE = {"a": torch.zeros((2, 3)), "b": (torch.zeros(4, dtype=torch.int32),
                                        None)}


def _save_two(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=5)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": (torch.ones(4, dtype=torch.int32), None)}
    ck.save(10, tree, extra={"t": 10}, blocking=True)
    tree2 = {"a": tree["a"] + 1.0, "b": (tree["b"][0] * 2, None)}
    ck.save(20, tree2, extra={"t": 20})      # in the background
    ck.wait()
    return ck, tree, tree2


def test_restore_roundtrip_keeps_structure(tmp_path):
    ck, _, tree2 = _save_two(tmp_path)
    out, extra = ck.restore(LIKE)
    assert extra == {"t": 20} and out["b"][1] is None
    assert_bits_equal(out, tree2)
    with open(os.path.join(str(tmp_path), "step_00000020",
                           "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert set(leaves) == {"a", "b/0"}
    assert all(len(v["sha256"]) == 64 for v in leaves.values())


def test_restore_falls_back_past_torn_leaf(tmp_path):
    ck, tree, _ = _save_two(tmp_path)
    with open(os.path.join(str(tmp_path), "step_00000020", "a.pt"),
              "wb") as f:
        f.write(b"PK\x03\x04")                       # torn mid-stream
    with pytest.warns(RuntimeWarning, match="unreadable"):
        out, extra = ck.restore(LIKE)
    assert extra["t"] == 10
    assert torch.equal(out["a"], tree["a"])
    with pytest.raises(CorruptCheckpointError):
        ck.restore(LIKE, step=20)                    # a named step is strict


def test_restore_falls_back_past_altered_leaf(tmp_path):
    """A leaf of the right size with other bytes fails its checksum."""
    ck, *_ = _save_two(tmp_path)
    path = os.path.join(str(tmp_path), "step_00000020", "b__0.pt")
    data = bytearray(open(path, "rb").read())
    data[-30] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.warns(RuntimeWarning, match="checksum"):
        _, extra = ck.restore(LIKE)
    assert extra["t"] == 10


def test_restore_falls_back_past_corrupt_manifest(tmp_path):
    ck, *_ = _save_two(tmp_path)
    with open(os.path.join(str(tmp_path), "step_00000020",
                           "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.warns(RuntimeWarning):
        _, extra = ck.restore(LIKE)
    assert extra["t"] == 10


def test_all_checkpoints_corrupt_raises(tmp_path):
    ck, *_ = _save_two(tmp_path)
    for step in (10, 20):
        with open(os.path.join(str(tmp_path), f"step_{step:08d}",
                               "manifest.json"), "w") as f:
            f.write("")
    with pytest.warns(RuntimeWarning):
        with pytest.raises(CorruptCheckpointError, match="all 2"):
            ck.restore(LIKE)


def test_interrupted_tmp_dir_is_invisible(tmp_path):
    ck, _, tree2 = _save_two(tmp_path)
    os.makedirs(os.path.join(str(tmp_path), "step_00000030.tmp"))
    assert ck.all_steps() == [10, 20]
    out, extra = ck.restore(LIKE)
    assert extra["t"] == 20 and torch.equal(out["a"], tree2["a"])


def test_latest_step_matches_reference(tmp_path):
    """``latest_step``: None with no checkpoint, else the newest step that
    landed, through rotation and past a dead ``.tmp`` save, as the
    reference's checkpointer says on the same saves."""
    from repro.checkpoint import Checkpointer as RefCheckpointer
    ck = Checkpointer(str(tmp_path / "port"), keep_n=2)
    ref = RefCheckpointer(str(tmp_path / "ref"), keep_n=2)
    assert ck.latest_step() is None and ref.latest_step() is None
    for step in (3, 1, 7, 5):
        ck.save(step, {"x": torch.full((2,), float(step))}, blocking=True)
        ref.save(step, {"x": jax.numpy.full((2,), float(step))},
                 blocking=True)
        assert ck.latest_step() == ref.latest_step()
    assert ck.all_steps() == ref.all_steps() == [5, 7]
    assert ck.latest_step() == 7
    os.makedirs(str(tmp_path / "port" / "step_00000009.tmp"))
    assert ck.latest_step() == 7


def test_rotation_and_shape_checks(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for step in (1, 2, 3):
        ck.save(step, {"x": torch.full((3,), float(step),
                                       dtype=torch.bfloat16)},
                extra={"t": step})
    ck.wait()
    assert ck.all_steps() == [2, 3]
    out, _ = ck.restore({"x": torch.zeros(3, dtype=torch.bfloat16)})
    assert out["x"].dtype == torch.bfloat16 and float(out["x"][0]) == 3.0
    with pytest.raises(CorruptCheckpointError, match="shape"):
        ck.restore({"x": torch.zeros(4)}, step=3)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(LIKE)


# --------------------------------------------------------- Experiment surface
def test_experiment_checkpoint_resume_and_recovery(tmp_path):
    base = dict(router="aif", scenario="zone-outage", n_cells=3,
                n_windows=T, device="cpu")
    r0 = api.run(api.Experiment(**base))
    assert r0.recovery is not None
    for k, v in r0.recovery.items():
        if isinstance(v, float):
            assert np.isfinite(v), (k, v)
    ck = str(tmp_path / "ck")
    r1 = api.run(api.Experiment(**base, checkpoint_every=20,
                                checkpoint_dir=ck))
    assert r1.resume_points == (20,)
    assert Checkpointer(ck).all_steps() == [20]
    assert_bits_equal(r0.final_carry, r1.final_carry)
    assert_bits_equal(r0.trace, r1.trace)
    np.testing.assert_array_equal(r0.fluid.n_success, r1.fluid.n_success)
    # the same curve; only the drop across the resume boundary is new
    assert r0.recovery["post_resume_forgetting"] == 0.0
    assert ({k: v for k, v in r0.recovery.items()
             if k != "post_resume_forgetting"}
            == {k: v for k, v in r1.recovery.items()
                if k != "post_resume_forgetting"})

    r2 = api.run(api.Experiment(**base, resume_from=ck))
    assert r2.resume_points == (20,)
    assert_bits_equal(r0.final_carry, r2.final_carry)
    np.testing.assert_array_equal(r0.fluid.n_success, r2.fluid.n_success)
    assert r2.trace.env.success.shape[0] == T - 20   # the resumed windows
    row = r1.summary()
    assert "recovery" in row and "watchdog_events" in row
    json.dumps(row)


def test_experiment_resume_mega_bit_identical(tmp_path):
    base = dict(router="aif", scenario="paper-burst", n_cells=3,
                n_windows=T, mega=True, device="cpu")
    r0 = api.run(api.Experiment(**base))
    ck = str(tmp_path / "ck")
    r1 = api.run(api.Experiment(**base, checkpoint_every=10,
                                checkpoint_dir=ck))
    assert r1.resume_points == (10, 20, 30)
    assert_bits_equal(r0.final_carry, r1.final_carry)
    r2 = api.run(api.Experiment(**base, resume_from=ck))
    assert r2.resume_points == (30,)
    assert_bits_equal(r0.final_carry, r2.final_carry)
    np.testing.assert_array_equal(r0.fluid.n_success, r2.fluid.n_success)


def test_experiment_resume_falls_back_past_a_torn_checkpoint(tmp_path):
    base = dict(router="aif", scenario="paper-burst", n_cells=2,
                n_windows=T, device="cpu")
    r0 = api.run(api.Experiment(**base))
    ck = str(tmp_path / "ck")
    api.run(api.Experiment(**base, checkpoint_every=10, checkpoint_dir=ck))
    assert Checkpointer(ck).all_steps() == [10, 20, 30]
    with open(os.path.join(ck, "step_00000030", "env__backlog.pt"),
              "wb") as f:
        f.write(b"")
    with pytest.warns(RuntimeWarning, match="step 30"):
        r2 = api.run(api.Experiment(**base, resume_from=ck))
    assert r2.resume_points == (20,)
    assert_bits_equal(r0.final_carry, r2.final_carry)


def test_experiment_checkpoint_validation(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        api.run(api.Experiment(scenario="paper-burst", n_cells=2,
                               n_windows=20, checkpoint_every=10,
                               device="cpu"))
    with pytest.raises(ValueError, match="boundary"):
        api.run(api.Experiment(scenario="paper-burst", n_cells=2,
                               n_windows=20, checkpoint_every=7,
                               checkpoint_dir=str(tmp_path), device="cpu"))
    ck = str(tmp_path / "ck")
    api.run(api.Experiment(router="uniform", n_cells=2, n_windows=20,
                           checkpoint_every=10, checkpoint_dir=ck,
                           device="cpu"))
    with pytest.raises(ValueError, match="scenario"):
        api.run(api.Experiment(router="uniform", scenario="steady",
                               n_cells=2, n_windows=20, resume_from=ck,
                               device="cpu"))
    with pytest.raises(ValueError, match="ends at"):
        api.run(api.Experiment(router="uniform", n_cells=2, n_windows=10,
                               resume_from=ck, device="cpu"))
