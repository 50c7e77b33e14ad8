"""The port's slice end to end: ``Experiment(router="aif", fused=True)``
against the reference on the same draws, plus the package contracts
(device default, import isolation, the paths that wait).

The reference runs its fused path with the Pallas kernel in interpret mode;
the port runs on the CPU (the plain PyTorch version of its CUDA kernel) with
the reference's key chain replayed by ``JaxChainNoise``.  Actions must be
equal on every tick of every cell.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro_torch import api
from repro_torch.core import mega, policies
from torch_port_ref import (JaxChainNoise, assert_close, assert_tree_close,
                            t2n)

SLICES = [("paper-burst", 3, 30), ("flaky-telemetry", 2, 22)]


@pytest.mark.parametrize("scenario,r,t", SLICES,
                         ids=[s[0] for s in SLICES])
def test_fused_experiment_matches_reference(scenario, r, t):
    seed = 0
    ref = ref_api.run(ref_api.Experiment(
        router="aif", scenario=scenario, n_cells=r, n_windows=t, seed=seed,
        fused=True, use_pallas=True))
    port = api.run(api.Experiment(router="aif", scenario=scenario,
                                  n_cells=r, n_windows=t, seed=seed,
                                  device="cpu"),
                   noise=JaxChainNoise(seed, r, t))
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    for field in ("success_pct", "p50_ms", "p95_ms", "obs_frac", "restarts"):
        assert_close(getattr(port, field), getattr(ref, field),
                     err_msg=field)
    assert_close(port.tier_share, ref.tier_share)
    assert_close(port.routed_share, ref.routed_share)
    assert_close(port.trace.obs_frac, ref.trace.obs_frac)
    assert_close(port.final_carry.belief, ref.final_carry.belief)
    assert_close(port.final_carry.model.b_counts,
                 ref.final_carry.model.b_counts)
    assert_tree_close(port.final_carry.model, ref.final_carry.model)
    assert_tree_close(port.final_carry.replay, ref.final_carry.replay)
    assert_tree_close(port.trace.env, ref.trace.env)
    assert port.watchdog_events == ref.watchdog_events == 0.0


def test_uniform_router_rollout_matches_reference():
    """The engine's flat path (no slow cadence, dwell 1)."""
    r, t, seed = 3, 20, 4
    ref = ref_api.run(ref_api.Experiment(router="uniform",
                                         scenario="flaky-telemetry",
                                         n_cells=r, n_windows=t, seed=seed))
    port = api.run(api.Experiment(router="uniform",
                                  scenario="flaky-telemetry", n_cells=r,
                                  n_windows=t, seed=seed, device="cpu"),
                   noise=JaxChainNoise(seed, r, t))
    assert_tree_close(port.trace.env, ref.trace.env)
    assert_close(port.success_pct, ref.success_pct)
    assert_close(port.p95_ms, ref.p95_ms)


def test_generator_noise_run_is_deterministic_and_healthy():
    e = api.Experiment(router="aif", scenario="paper-burst", n_cells=2,
                       n_windows=12, seed=3, device="cpu")
    a, b = api.run(e), api.run(e)
    np.testing.assert_array_equal(t2n(a.trace.actions), t2n(b.trace.actions))
    assert a.success_pct == b.success_pct
    acts = t2n(a.trace.actions)
    assert acts.min() >= 0 and acts.max() < 20
    # dwell 5: actions change only on selecting ticks
    assert (acts[1:5] == acts[0]).all() and (acts[6:10] == acts[5]).all()
    assert np.isfinite([a.success_pct, a.p50_ms, a.p95_ms]).all()
    q = t2n(a.final_carry.belief)
    np.testing.assert_allclose(q.sum(-1), 1.0, rtol=1e-5)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card contract "
                    "cannot be observed")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run(api.Experiment(n_cells=2, n_windows=5))
    with pytest.raises(RuntimeError):
        api.AifRouter().init_carry(2)


def test_waiting_paths_raise_not_implemented():
    # warm promotion of a dense per-tick carry onto the mega path is ported
    router = api.AifRouter(mega=True)
    warm = router.init_carry(2, "cpu")
    warm = warm._replace(t=torch.full_like(warm.t, 10))
    state = mega.init_mega_state(router.cfg, 2, 20, device="cpu",
                                 from_agent_state=warm)
    assert state.cache.b_base is not None
    # a fleet graph and fault schedules in a mega window (once refused,
    # ROADMAP A8b) run and match the reference's mega runs
    for scenario, r in (("ring-spillover", 3), ("zone-outage", 2)):
        ref = ref_api.run(ref_api.Experiment(mega=True, scenario=scenario,
                                             n_cells=r, n_windows=20))
        port = api.run(api.Experiment(mega=True, scenario=scenario,
                                      n_cells=r, n_windows=20, device="cpu"),
                       noise=JaxChainNoise(0, r, 20))
        np.testing.assert_array_equal(t2n(port.trace.actions),
                                      np.asarray(ref.trace.actions))
        for field in ("success_pct", "p95_ms", "offload_frac"):
            assert_close(getattr(port, field), getattr(ref, field),
                         err_msg=f"{scenario}.{field}")
        assert_tree_close(port.final_carry, ref.final_carry,
                          path=f"{scenario}.carry")
    # the sharded engine (once refused, A10): one shard on the mega path
    # runs the unsharded program, against the reference's unsharded run
    e = api.Experiment(mega=True, n_cells=2, n_windows=20, device="cpu",
                       shard=api.ShardSpec(devices=1))
    one = api.run(e, noise=JaxChainNoise(0, 2, 20))
    ref = ref_api.run(ref_api.Experiment(mega=True, n_cells=2, n_windows=20))
    assert one.trace is None and one.cells_per_device == 2
    for field in ("success_pct", "obs_frac", "restarts"):
        assert_close(getattr(one, field), getattr(ref, field),
                     err_msg=field)
    assert_tree_close(one.final_carry, ref.final_carry, path="sharded.carry")


def test_uniform_router_weights_are_the_balanced_row():
    r = api.UniformRouter()
    obs = api.RouterObs(raw_obs=torch.zeros(2, 4),
                        tier_utilization=torch.zeros(2, 3),
                        tier_up=torch.ones(2, 3),
                        tier_queue=torch.zeros(2, 3), t_idx=0)
    _, w, _ = r.step((), obs, None, None)
    np.testing.assert_array_equal(
        t2n(w), np.tile(policies.balanced_weights(3).astype(np.float32),
                        (2, 1)))


def test_port_imports_neither_jax_nor_the_reference():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {os.path.dirname(src)!r})\n"
        "import chip_smoke\n"
        "import repro_torch, repro_torch.api, repro_torch.noise\n"
        "import repro_torch.core.fleet, repro_torch.kernels.efe.ops\n"
        "import repro_torch.kernels.build, repro_torch.envsim\n"
        "import repro_torch.models, repro_torch.models.convert\n"
        "import repro_torch.models.moe, repro_torch.models.blocks\n"
        "import repro_torch.configs, repro_torch.serving\n"
        "import repro_torch.kernels.attention.ops\n"
        "import repro_torch.kernels.ssd.ops, repro_torch.models.ssm\n"
        "import repro_torch.envsim.routers, repro_torch.envsim.simulator\n"
        "import repro_torch.checkpoint, repro_torch.envsim.chaos\n"
        "import repro_torch.baselines, repro_torch.envsim.harness\n"
        "import repro_torch.core.agent, repro_torch.core.spaces\n"
        "import repro_torch.training, repro_torch.data\n"
        "import repro_torch.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.specs, repro_torch.launch.op_cost\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.hillclimb\n"
        "import glob, importlib.util\n"
        f"root = {os.path.dirname(src)!r}\n"
        "paths = sorted(glob.glob(root + '/examples/*_torch.py')"
        " + glob.glob(root + '/tools/*_torch.py'))\n"
        "assert len(paths) >= 10, paths\n"
        "for p in paths:\n"
        "    spec = importlib.util.spec_from_file_location("
        "'m_' + os.path.basename(p)[:-3], p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_neither_jax_nor_the_reference():
    """Lazy imports inside functions too: no import statement of the port,
    of chip_smoke.py, of the port's event-protocol script or of the port's
    examples and tools (``examples/*_torch.py``, ``tools/*_torch.py``)
    names ``jax`` or ``repro``."""
    root = os.path.join(os.path.dirname(__file__), "..")
    files = [os.path.join(root, "chip_smoke.py"),
             os.path.join(root, "tools", "event_table1.py")]
    for d in ("examples", "tools"):
        files += [os.path.join(root, d, n)
                  for n in sorted(os.listdir(os.path.join(root, d)))
                  if n.endswith("_torch.py")]
    for d, _, names in os.walk(os.path.join(root, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
