"""repro_torch.api — the public experiment surface of the port.

* Router protocol (:mod:`repro_torch.api.router`) and the AIF router
  (:mod:`repro_torch.api.aif`),
* engine (:mod:`repro_torch.api.engine`): :func:`rollout`, the closed loop,
* experiments (:mod:`repro_torch.api.experiment`): :class:`Experiment` and
  :func:`run`.

Quickstart::

    from repro_torch import api
    res = api.run(api.Experiment(router="aif", scenario="paper-burst",
                                 n_cells=1024, n_windows=300))
"""
from repro_torch.api.aif import AifRouter
from repro_torch.api.engine import rollout
from repro_torch.api.experiment import (ROUTERS, Experiment, RunResult, run)
from repro_torch.api.router import Router, RouterObs, TickInfo, UniformRouter

__all__ = ["AifRouter", "Experiment", "ROUTERS", "Router", "RouterObs",
           "RunResult", "TickInfo", "UniformRouter", "rollout", "run"]
