"""The port's examples (``examples/*_torch.py``) against the reference's.

* Configuration parity: each reference script runs under ``runpy`` with its
  entry calls replaced by recorders (``api.run``/``api.compare``,
  ``run_experiment``, the serving and training classes), and so does the
  port's ``main``; what each builds (experiments, ``SimConfig``,
  ``ModelConfig``s, data, train and trainer configs, the server's ``run``
  arguments) must be equal field by field, read from the scripts
  themselves.  Differences by design are named in ``PORT_ONLY``: the
  port's ``device``, its ``fused=True`` default (the fused per-tick path,
  kernel B1 on the card; the reference's unfused default computes the same
  actions), and its file paths under the temporary directory.
* CPU run: each port example runs on the CPU at a small size and prints
  the reference's labelled lines in the reference's order.
* Bit equality: ``quickstart``'s uniform baseline equals the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import runpy
import shutil
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

#: Experiment fields that differ by design (module docstring).
PORT_ONLY = {"fused", "use_pallas", "device"}


class _Stop(Exception):
    """Raised by a recorder once it has what the test compares."""


def port_module(name: str):
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name: str, argv: list, monkeypatch) -> None:
    """The reference's ``examples/<name>.py`` as ``__main__`` with
    ``argv``, until a recorder stops it."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    with pytest.raises(_Stop):
        runpy.run_path(path, run_name="__main__")


def run_port(mod, argv: list) -> None:
    with pytest.raises(_Stop):
        mod.main(argv)


class Calls:
    """A stand-in for a function: records (args, kwargs) of each call and
    raises :class:`_Stop` at call ``stop_at``; before that it returns
    ``ret(args, kwargs)``."""

    def __init__(self, stop_at: int, ret=lambda a, k: None):
        self.calls, self.stop_at, self.ret = [], stop_at, ret

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        if len(self.calls) == self.stop_at:
            raise _Stop
        return self.ret(args, kwargs)


def recorder_class(calls: list, stop_on: str | None = None):
    """A stand-in class: each instance records its constructor's
    arguments in ``calls`` (and the calls of ``stop_on``, which stops)."""

    class Recorded:
        def __init__(self, *args, **kwargs):
            self.args, self.kwargs = args, kwargs
            calls.append(self)

        def __getattr__(self, attr):
            if attr == stop_on:
                def stop(*args, **kwargs):
                    self.stopped_with = (args, kwargs)
                    raise _Stop
                return stop
            raise AttributeError(attr)

    return Recorded


def fields(obj) -> dict:
    """A config dataclass as a dict (nested dataclasses too), without the
    port's own model-config fields that hold their defaults (the
    reference's ``ModelConfig`` has no such field; one set otherwise stays
    and shows)."""
    from repro.models import ModelConfig as RefModelConfig
    from repro_torch.models import ModelConfig
    out = dataclasses.asdict(obj)
    if isinstance(obj, ModelConfig):
        ref = {f.name for f in dataclasses.fields(RefModelConfig)}
        for f in dataclasses.fields(ModelConfig):
            if f.name not in ref and out[f.name] == f.default:
                del out[f.name]
    return out


def same_experiments(ref: list, port: list) -> None:
    assert len(ref) == len(port) > 0
    for r, p in zip(ref, port):
        rf = {k: v for k, v in vars(r).items() if k not in PORT_ONLY}
        pf = {k: v for k, v in vars(p).items() if k not in PORT_ONLY}
        assert rf == pf
        assert p.fused and not p.mega      # the fused path: B1 on the card
        assert p.device == "cpu"


# ------------------------------------------------------------ the fleet API
FLEET = {  # example -> (entry the script calls, calls before it stops)
    "fleet_quickstart": ("compare", 1),
    "unreliable_telemetry": ("run", 2),
    "hetero_fleet": ("run", 2),
    "networked_fleet": ("run", 4),
    "mega_fleet": ("run", 1),
}


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("name", sorted(FLEET))
def test_fleet_examples_build_the_reference_experiments(name, quick,
                                                        monkeypatch):
    from repro import api as ref_api
    from repro_torch import api
    entry, n = FLEET[name]
    argv = ["--quick"] if quick else []
    ref_calls, port_calls = Calls(n), Calls(n)
    monkeypatch.setattr(ref_api, entry, ref_calls)
    run_reference(name, argv, monkeypatch)
    monkeypatch.setattr(api, entry, port_calls)
    run_port(port_module(name), argv + ["--device", "cpu"])

    def experiments(calls):
        out = []
        for args, _ in calls.calls:
            out += list(args[0]) if entry == "compare" else [args[0]]
        return out

    same_experiments(experiments(ref_calls), experiments(port_calls))


# ------------------------------------------------------ the event simulator
def test_quickstart_builds_the_reference_runs(monkeypatch):
    import repro.envsim as ref_envsim
    mod = port_module("quickstart")
    fake = lambda a, k: types.SimpleNamespace(  # noqa: E731
        success_rate=0.0, p50_ms=0.0, p95_ms=0.0)
    sides = {}
    for side in ("ref", "port"):
        calls, routers = Calls(2, fake), []
        if side == "ref":
            monkeypatch.setattr(ref_envsim, "run_experiment", calls)
            monkeypatch.setattr(ref_envsim, "AifRouter",
                                recorder_class(routers))
            run_reference("quickstart", [], monkeypatch)
        else:
            monkeypatch.setattr(mod, "run_experiment", calls)
            monkeypatch.setattr(mod, "AifRouter", recorder_class(routers))
            run_port(mod, ["--device", "cpu"])
        sides[side] = (calls.calls, routers)
    (ref_calls, ref_routers), (port_calls, port_routers) = (sides["ref"],
                                                            sides["port"])
    for calls in (ref_calls, port_calls):
        assert [type(a[0]).__name__ for a, _ in calls] == ["UniformRouter",
                                                           "Recorded"]
    for (ra, rk), (pa, pk) in zip(ref_calls, port_calls):
        assert fields(ra[1]) == fields(pa[1])          # SimConfig
        assert ra[2:] == pa[2:] and rk == pk           # duration, seed
    assert ref_routers[0].kwargs == {"seed": 0}
    assert port_routers[0].kwargs == {"seed": 0,
                                      "device": torch.device("cpu")}


def test_quickstart_uniform_line_equals_the_reference_to_the_bit():
    import repro.baselines as ref_baselines
    import repro.envsim as ref_envsim
    from repro_torch.baselines import UniformRouter
    from repro_torch.envsim import SimConfig, run_experiment
    ref = ref_envsim.run_experiment(ref_baselines.UniformRouter(),
                                    ref_envsim.SimConfig(), 120, seed=0)
    port = run_experiment(UniformRouter(), SimConfig(), 120, seed=0)
    assert port.p50_ms == ref.p50_ms == 2335.0991383517226
    assert (port.success_rate, port.p95_ms) == (ref.success_rate, ref.p95_ms)
    lines = port_module("quickstart").main(["--quick", "--device", "cpu"])
    assert lines[2] == (f"success {100 * ref.success_rate:.1f}%  P50 "
                        f"{ref.p50_ms:.0f} ms  P95 {ref.p95_ms:.0f} ms")


# ------------------------------------------------------------------ serving
def test_serve_multitier_builds_the_reference_server(monkeypatch):
    import repro.envsim.routers as ref_routers
    import repro.serving as ref_serving
    mod = port_module("serve_multitier")
    sides = {}
    for side in ("ref", "port"):
        engines, routers, servers = [], [], []
        target = ref_serving if side == "ref" else mod
        monkeypatch.setattr(target, "ServingEngine", recorder_class(engines))
        monkeypatch.setattr(target, "MultiTierServer",
                            recorder_class(servers, stop_on="run"))
        if side == "ref":
            monkeypatch.setattr(ref_routers, "AifRouter",
                                recorder_class(routers))
            run_reference("serve_multitier", [], monkeypatch)
        else:
            monkeypatch.setattr(mod, "AifRouter", recorder_class(routers))
            run_port(mod, ["--device", "cpu"])
        sides[side] = engines, routers, servers
    (re_, rr, rs), (pe, pr, ps) = sides["ref"], sides["port"]
    assert len(re_) == len(pe) == 3
    for r, p in zip(re_, pe):
        assert fields(r.args[0]) == fields(p.args[0])    # ModelConfig
        assert {**r.kwargs, "device": torch.device("cpu")} == p.kwargs
    assert fields(rr[0].kwargs.pop("disc")) == fields(pr[0].kwargs.pop("disc"))
    assert {**rr[0].kwargs, "device": torch.device("cpu")} == pr[0].kwargs
    (r_srv,), (p_srv,) = rs, ps
    assert [t.steps_per_tick for t in r_srv.args[0]] == \
        [t.steps_per_tick for t in p_srv.args[0]] == [1, 1, 3]
    assert r_srv.kwargs == p_srv.kwargs
    assert r_srv.stopped_with == p_srv.stopped_with


# ----------------------------------------------------------------- training
def _train_recorders(trainers, stop_on):
    models, pipes = [], []
    monkey = {"build_model": lambda cfg, *a, **k: models.append(cfg) or cfg,
              "SyntheticPipeline": recorder_class(pipes),
              "Trainer": recorder_class(trainers, stop_on=stop_on)}
    return monkey, models, pipes


def _same_trainers(ref: list, port: list, ref_dirs: list, port_dirs: list):
    assert len(ref) == len(port) > 0
    for r, p, rd, pd in zip(ref, port, ref_dirs, port_dirs):
        r_args, p_args = r.args, p.args
        assert fields(r_args[1]) == fields(p_args[1])       # TrainConfig
        rt, pt = fields(r_args[3]), fields(p_args[3])      # TrainerConfig
        assert rt.pop("ckpt_dir") == rd and pt.pop("ckpt_dir") == pd
        assert rt == pt


def test_train_small_lm_builds_the_reference_run(monkeypatch):
    import repro.data as ref_data
    import repro.models as ref_models
    import repro.training as ref_training
    mod = port_module("train_small_lm")
    sides = {}
    for side in ("ref", "port"):
        trainers = []
        rec, models, pipes = _train_recorders(trainers, "run")
        if side == "ref":
            monkeypatch.setattr(ref_models, "build_model",
                                rec["build_model"])
            monkeypatch.setattr(ref_data, "SyntheticPipeline",
                                rec["SyntheticPipeline"])
            monkeypatch.setattr(ref_training, "Trainer", rec["Trainer"])
            run_reference("train_small_lm", [], monkeypatch)
        else:
            for k, v in rec.items():
                monkeypatch.setattr(mod, k, v)
            run_port(mod, ["--device", "cpu"])
        sides[side] = models, pipes, trainers
    (rm, rp, rt), (pm, pp, pt) = sides["ref"], sides["port"]
    assert [fields(c) for c in rm] == [fields(c) for c in pm]
    assert [fields(p.args[0]) for p in rp] == [fields(p.args[0]) for p in pp]
    assert pp[0].kwargs == {"device": torch.device("cpu")}
    _same_trainers(rt, pt, ["/tmp/repro_train_small"],
                   [os.path.join(tempfile.gettempdir(),
                                 "repro_torch_train_small")])


def test_elastic_failover_builds_the_reference_runs(monkeypatch, tmp_path):
    """All three trainers (preempted, uninterrupted, extended to 90).  The
    reference builds its ``FailureInjector(fail_at_steps=(23, 57))`` but
    never hands it to its ``Trainer`` (its run survives 0 preemptions,
    ROADMAP R7); the port's does."""
    import repro.data as ref_data
    import repro.models as ref_models
    import repro.training as ref_training
    mod = port_module("elastic_failover")
    sides, removed = {}, []
    monkeypatch.setattr(shutil, "rmtree",
                        lambda path, **k: removed.append(path))
    for side in ("ref", "port"):
        trainers, injectors = [], []
        rec, models, pipes = _train_recorders(trainers, None)
        leaf = np.zeros(1) if side == "ref" else torch.zeros(1)
        state = types.SimpleNamespace(params={"w": leaf})

        def run(self, *a, **k):
            return state

        rec["Trainer"].run = run
        restarts = lambda make: (make().run(), 0)  # noqa: E731
        if side == "ref":
            monkeypatch.setattr(ref_models, "build_model",
                                rec["build_model"])
            monkeypatch.setattr(ref_data, "SyntheticPipeline",
                                rec["SyntheticPipeline"])
            monkeypatch.setattr(ref_training, "Trainer", rec["Trainer"])
            monkeypatch.setattr(ref_training, "run_with_restarts", restarts)
            monkeypatch.setattr(ref_training, "FailureInjector",
                                recorder_class(injectors))
            path = os.path.join(ROOT, "examples", "elastic_failover.py")
            monkeypatch.setattr(sys, "argv", [path])
            runpy.run_path(path, run_name="__main__")
        else:
            for k, v in rec.items():
                monkeypatch.setattr(mod, k, v)
            monkeypatch.setattr(mod, "run_with_restarts", restarts)
            monkeypatch.setattr(mod, "FailureInjector",
                                recorder_class(injectors))
            monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
            mod.main(["--device", "cpu"])
        sides[side] = models, pipes, trainers, injectors
    (rm, rp, rt, ri), (pm, pp, pt, pi) = sides["ref"], sides["port"]
    assert len(rm) == len(pm) == 3
    assert [fields(c) for c in rm] == [fields(c) for c in pm]
    assert [fields(p.args[0]) for p in rp] == [fields(p.args[0]) for p in pp]
    ours = [str(tmp_path / d) for d in ("repro_torch_ft_a",
                                        "repro_torch_ft_b",
                                        "repro_torch_ft_a")]
    _same_trainers(rt, pt, ["/tmp/repro_ft_a", "/tmp/repro_ft_b",
                            "/tmp/repro_ft_a"], ours)
    assert removed == ["/tmp/repro_ft_a", "/tmp/repro_ft_b"] + ours[:2]
    assert [fields(t.args[3])["total_steps"] for t in pt] == [80, 80, 90]
    assert [i.kwargs for i in ri] == [i.kwargs for i in pi] == \
        [{"fail_at_steps": (23, 57)}]
    assert all(len(t.args) == 4 and "failure_injector" not in t.kwargs
               for t in rt)
    assert pt[0].kwargs["failure_injector"] is pi[0]
    assert pt[1].kwargs["failure_injector"] is None


# ------------------------------------------------------------- CPU runs
#: Each example's labelled lines, in the reference's order (prefixes).
LABELS = {
    "quickstart": ["testbed: capacity", "\n-- uniform baseline", "success ",
                   "\n-- AIF-Router", "success ", "  t=   0s..",
                   "  t=  ", "  t=  ", "  tier share of successes",
                   "  pod restarts", "\nthe router shifts"],
    "fleet_quickstart": ["fleet of 4 cells x 120", "", "| scenario |",
                         "  windows   0..", "  windows  40..",
                         "  windows  80..", "  per-cell success",
                         "  [", "\nEach cell learns"],
    "unreliable_telemetry": ["fleet of 3 AIF routers x 100",
                             "\n  clean telemetry",
                             "  degraded telemetry",
                             "  clean-vs-degraded success gap",
                             "  belief health under degradation",
                             "\nMasked modalities"],
    "hetero_fleet": ["heterogeneous fleet, 60", "  paper-3tier:",
                     "  continuum-5tier:", "\nran 7 cells x 60",
                     "\n  paper-3tier (K=3):", "    success ",
                     "    fleet-mean routing weights",
                     "\n  continuum-5tier (K=5):", "    success ",
                     "    fleet-mean routing weights", "\nEach shard"],
    "networked_fleet": ["ring fleet, R=8 cells x T=60", "\nran 4 experiments",
                        "configuration", "no graph (control)",
                        "ring + least_loaded", "ring + nn_offload",
                        "ring + aif", "\nspillover absorbed the burst",
                        "Every cross-cell exchange"],
    "mega_fleet": ["devices: 1", "R=10,000 cells x T=25", "success     ",
                   "latency     P50", "tier share  ", "restarts    "],
    "serve_multitier": ["completed ", "latency P50", "routed share L/M/H",
                        "mean router weights", "late-phase weights"],
}
SMALL_TRAIN = ["--dmodel", "32", "--layers", "1", "--steps", "6", "--seq",
               "16", "--batch", "4"]


def assert_labelled(lines: list, labels: list) -> None:
    it = iter(lines)
    for label in labels:
        assert any(line.startswith(label) for line in it), (label, lines)


@pytest.mark.parametrize("name", sorted(LABELS))
def test_example_runs_on_the_cpu(name):
    argv = ["--device", "cpu"] + ([] if name == "serve_multitier"
                                  else ["--quick"])
    lines = port_module(name).main(argv)
    assert_labelled(lines, LABELS[name])
    if name == "serve_multitier":
        assert int(lines[0].split()[1]) > 0


def test_train_small_lm_runs_on_the_cpu(tmp_path):
    lines = port_module("train_small_lm").main(
        SMALL_TRAIN + ["--ckpt", str(tmp_path), "--device", "cpu"])
    assert_labelled(lines, ["model: ", "step     0 loss", "loss: ",
                            "checkpoints: [] in"])


def test_elastic_failover_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    lines = port_module("elastic_failover").main(["--device", "cpu"])
    assert_labelled(lines, [
        "== run with preemptions", "[supervisor] simulated preemption at "
        "step 23", "[supervisor] simulated preemption at step 57",
        "survived 2 preemptions", "\n== uninterrupted reference run ==",
        "max param divergence vs uninterrupted: 0.00e+00",
        "\n== elastic reshape", "restored checkpoint at step 80",
        "resumed and extended to step 90"])
    assert sorted(os.listdir(tmp_path)) == ["repro_torch_ft_a",
                                            "repro_torch_ft_b"]


def test_examples_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in list(LABELS) + ["train_small_lm", "elastic_failover"]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_module(name).main(["--quick"] if name in FLEET else [])
