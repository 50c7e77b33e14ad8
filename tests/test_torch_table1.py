"""The paper's Table-1 comparison on the port: every row of
``table1_grid(n_cells=3, n_windows=30)`` against the reference's run of the
same experiment (mirrors ``tests/test_api.py``'s engine, ``compare`` and
registry rows).

Each row runs the reference's ``Experiment`` (the AIF rows on its fused
path with the plain oracle, the port's default path) and the port's on
the CPU with the reference's key chain replayed by ``JaxChainNoise``, all
draws in the reference's R1 PRNG mode.  Actions must be equal on every
tick of every cell, floats within the parity bar.
"""
import json

import jax
import numpy as np
import pytest

from repro import api as ref_api
from repro_torch import api
from torch_port_ref import JaxChainNoise, assert_close, assert_tree_close, t2n

R, T = 3, 30
GRID = api.table1_grid(n_cells=R, n_windows=T, device="cpu")


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def ref_run(e: api.Experiment):
    """The reference's run of the port's experiment ``e``."""
    return ref_api.run(ref_api.Experiment(
        router=e.router, scenario=e.scenario, n_cells=e.n_cells,
        n_windows=e.n_windows, seed=e.seed, fused=e.fused))


def assert_run_matches(port, ref):
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    for field in ("success_pct", "success_std", "p50_ms", "p95_ms",
                  "obs_frac", "restarts", "watchdog_events"):
        assert_close(getattr(port, field), getattr(ref, field),
                     err_msg=field)
    assert_close(port.tier_share, ref.tier_share)
    assert_close(port.routed_share, ref.routed_share)
    assert_close(port.trace.routing_weights, ref.trace.routing_weights)
    assert_tree_close(port.trace.env, ref.trace.env)


@pytest.mark.parametrize("e", GRID,
                         ids=[f"{e.scenario}-{e.router}" for e in GRID])
def test_table1_row_matches_reference(e):
    ref = ref_run(e)
    port = api.run(e, noise=JaxChainNoise(e.seed, R, T))
    assert port.name == ref.name == e.router
    assert_run_matches(port, ref)
    if e.router != "aif":
        assert_tree_close(port.final_carry, ref.final_carry,
                          path=f"{e.router}.carry")


def test_compare_runs_the_whole_grid():
    comp = api.compare(GRID)
    md = comp.markdown()
    assert md.count("\n") == 1 + len(GRID)      # header + rule + 16 rows
    for token in api.TABLE1_ROUTERS + ("paper-burst", "flaky-telemetry"):
        assert token in md
    js = comp.to_json()
    assert set(js) == {"paper-burst", "flaky-telemetry"}
    assert set(js["paper-burst"]) == set(api.TABLE1_ROUTERS)
    assert js["flaky-telemetry"]["uniform"]["obs_frac"] < 1.0
    assert js["paper-burst"]["aif"]["device"] == "cpu"
    for rows in js.values():
        for row in rows.values():
            assert np.isfinite([row["success_pct"], row["p50_ms"],
                                row["p95_ms"]]).all()
    json.dumps(js)


def test_compare_markdown_and_json_suffix_repeated_rows(tmp_path):
    exps = [api.Experiment(router=r, scenario=s, n_cells=2, n_windows=20,
                           device="cpu")
            for s in ("steady", "flaky-telemetry")
            for r in ("uniform", "least_loaded")]
    exps.append(api.Experiment(router="uniform", scenario="steady",
                               n_cells=2, n_windows=20, seed=1,
                               device="cpu"))
    comp = api.compare(exps)
    assert comp.markdown().count("\n") == 6      # header + rule + 5 rows
    assert str(comp) == comp.markdown()
    js = comp.to_json()
    assert set(js["steady"]) == {"uniform", "least_loaded", "uniform#2"}
    assert js["flaky-telemetry"]["uniform"]["obs_frac"] < 1.0
    path = tmp_path / "table1.json"
    comp.dump(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(js))


def test_registry_covers_the_reference():
    assert set(api.ROUTERS) == set(ref_api.ROUTERS)
    assert api.TABLE1_ROUTERS == ref_api.TABLE1_ROUTERS
    from repro.api import experiment as ref_exp
    from repro.envsim import SimConfig as RefSimConfig
    from repro_torch.api import experiment
    from repro_torch.envsim import SimConfig
    assert experiment._capacity_weights(SimConfig()) == \
        ref_exp._capacity_weights(RefSimConfig()) == (0.15, 0.23, 0.62)


def test_experiment_unknown_names_raise():
    with pytest.raises(KeyError, match="unknown router"):
        api.run(api.Experiment(router="nope", n_cells=2, n_windows=5,
                               device="cpu"))
    with pytest.raises(KeyError, match="unknown scenario"):
        api.run(api.Experiment(scenario="nope", n_cells=2, n_windows=5,
                               device="cpu"))
    with pytest.raises(ValueError, match="tiers"):
        api.run(api.Experiment(router=api.UniformRouter(tiers=5),
                               n_cells=2, n_windows=5, device="cpu"))


def test_experiment_router_instance_with_path_options_raises():
    """A Router instance with another path asked of the Experiment raises,
    as the reference does, instead of running the instance's own path."""
    from repro.envsim import SimConfig as RefSimConfig
    from repro_torch.envsim import SimConfig
    with pytest.raises(ValueError, match="silently ignoring"):
        ref_api.Experiment(router=ref_api.UniformRouter(),
                           mega=True).resolve_router(RefSimConfig())
    for kw in ({"mega": True}, {"fused": False},
               {"fused": False, "mega": True}):
        e = api.Experiment(router=api.UniformRouter(), n_cells=2,
                           n_windows=5, device="cpu", **kw)
        with pytest.raises(ValueError, match="silently ignoring"):
            e.resolve_router(SimConfig())
        with pytest.raises(ValueError, match="silently ignoring"):
            api.run(e)
    # the defaults leave the instance's own path alone
    r = api.UniformRouter()
    assert api.Experiment(router=r).resolve_router(SimConfig()) is r


def test_experiment_label_and_per_device_wall():
    """``label`` names the row (the reference's ``Experiment.label``), so two
    variants of one router stay apart in a grid; ``per_device_wall_s``
    is the wall clock of the one host loop, sharded or not."""
    kw = dict(router="uniform", n_cells=2, n_windows=10)
    ref = ref_api.run(ref_api.Experiment(label="static", **kw))
    res = api.run(api.Experiment(label="static", device="cpu", **kw))
    assert res.name == ref.name == "static"
    s = res.summary()
    assert s["router"] == "static" and s["device"] == "cpu"
    assert set(s) == set(ref.summary()) | {"device"}
    assert res.per_device_wall_s == res.wall_s > 0.0
    assert s["per_device_wall_s"] == round(res.wall_s, 2)
    sharded = api.run(api.Experiment(label="static", device="cpu",
                                     shard=api.ShardSpec(devices=1), **kw))
    assert sharded.per_device_wall_s == sharded.wall_s > 0.0
    comp = api.compare([api.Experiment(label=name, device="cpu", **kw)
                        for name in ("a", "b")])
    assert list(comp.to_json()["paper-burst"]) == ["a", "b"]
    assert api.Experiment(**kw).name == "uniform"


def test_experiment_run_and_summary():
    res = api.run(api.Experiment(router="least_loaded", n_cells=2,
                                 n_windows=25, device="cpu"))
    s = res.summary()
    assert s["router"] == "least_loaded"
    assert 0.0 < s["success_pct"] <= 100.0
    assert len(s["tier_share_of_success"]) == 3
    assert s["obs_frac"] == 1.0
    assert "recovery" not in s and res.recovery is None
