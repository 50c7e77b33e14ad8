"""repro_torch.api — the public experiment surface of the port.

* Router protocol and baselines (:mod:`repro_torch.api.router`) and the AIF
  router (:mod:`repro_torch.api.aif`),
* engine (:mod:`repro_torch.api.engine`): :func:`rollout`, the closed loop,
  :func:`resumable_rollout`, one checkpointable chunk of it, and
  :func:`sharded_rollout` over the row blocks of a sharded fleet
  (:class:`ShardSpec`, :mod:`repro_torch.api.shard`),
* experiments (:mod:`repro_torch.api.experiment`): :class:`Experiment`,
  :func:`run`, and the Table-1 comparison :func:`compare` /
  :func:`table1_grid`; :class:`FleetGraph` for networked fleets
  (``Experiment(graph=...)``).

Quickstart::

    from repro_torch import api
    res = api.run(api.Experiment(router="aif", scenario="paper-burst",
                                 n_cells=1024, n_windows=300))
    print(api.compare(api.table1_grid(n_cells=32, n_windows=300)).markdown())
"""
from repro_torch.api.aif import AifRouter
from repro_torch.api.engine import (resumable_rollout, rollout,
                                    sharded_finalize,
                                    sharded_resumable_rollout,
                                    sharded_rollout)
from repro_torch.api.experiment import (ROUTERS, TABLE1_ROUTERS, Comparison,
                                        Experiment, FleetMetricsReducer,
                                        RunResult, compare, run, table1_grid)
from repro_torch.api.router import (CapacityRouter, LeastLoadedRouter,
                                    MinResponseRouter, RoundRobinRouter,
                                    Router, RouterObs, ThompsonCarry,
                                    ThompsonRouter, TickInfo, UcbCarry,
                                    UcbRouter, UniformRouter)
from repro_torch.api.shard import ShardSpec
from repro_torch.core.graph import FleetGraph

__all__ = ["AifRouter", "CapacityRouter", "Comparison", "Experiment",
           "FleetGraph", "FleetMetricsReducer", "LeastLoadedRouter",
           "MinResponseRouter", "ROUTERS", "RoundRobinRouter", "Router",
           "RouterObs", "RunResult", "ShardSpec", "TABLE1_ROUTERS",
           "ThompsonCarry", "ThompsonRouter", "TickInfo", "UcbCarry",
           "UcbRouter", "UniformRouter", "compare", "resumable_rollout",
           "rollout", "run", "sharded_finalize", "sharded_resumable_rollout",
           "sharded_rollout", "table1_grid"]
