"""AIF core of the port: topology, policies, spaces, generative model,
belief, learning, agent state and the fused fleet tick.

Public API (the reference's ``repro.core`` names):
  Topology, PolicySpec, presets   — repro_torch.core.topology
  AifConfig, GenerativeModel      — repro_torch.core.generative
  AgentState, init_agent_state,
  fast_step, slow_step, tick      — repro_torch.core.agent
  expected_free_energy            — repro_torch.core.efe
  update_belief                   — repro_torch.core.belief
  policy_table, routing_weights   — repro_torch.core.policies
  DiscretizationConfig            — repro_torch.core.spaces
  init_fleet_state, fleet_tick,
  fleet_rollout, FleetGroup,
  hetero_fleet_rollout            — repro_torch.core.fleet
"""
from repro_torch.core.agent import (AgentState, StepInfo, fast_step,
                                    init_agent_state, slow_step, tick)
from repro_torch.core.belief import update_belief
from repro_torch.core.efe import (EfeBreakdown, expected_free_energy,
                                  select_action)
from repro_torch.core.fleet import (FleetGroup, FleetTrace, fleet_fast_step,
                                    fleet_light_step, fleet_rollout,
                                    fleet_slow_step, fleet_tick,
                                    hetero_fleet_rollout, init_fleet_state)
from repro_torch.core.generative import (AifConfig, GenerativeModel,
                                         ModelCache, derive_cache,
                                         init_generative_model)
from repro_torch.core.learning import ReplayBuffer, init_replay, slow_update
from repro_torch.core.policies import (BALANCED_ACTION, generate_policy_table,
                                       n_actions, policy_table,
                                       routing_weights)
from repro_torch.core.spaces import (DiscretizationConfig,
                                     discretize_observation)
from repro_torch.core.topology import (TOPOLOGIES, PolicySpec, Topology,
                                       default_topology, five_tier_topology,
                                       get_topology)

__all__ = [
    "AgentState", "StepInfo", "fast_step", "init_agent_state", "slow_step",
    "tick", "update_belief", "EfeBreakdown", "expected_free_energy",
    "select_action", "FleetGroup", "FleetTrace", "fleet_fast_step",
    "fleet_light_step", "fleet_rollout", "fleet_slow_step", "fleet_tick",
    "hetero_fleet_rollout", "init_fleet_state", "AifConfig", "ModelCache",
    "derive_cache",
    "GenerativeModel", "init_generative_model", "ReplayBuffer", "init_replay",
    "slow_update", "BALANCED_ACTION", "generate_policy_table", "n_actions",
    "policy_table", "routing_weights", "DiscretizationConfig",
    "discretize_observation", "TOPOLOGIES", "PolicySpec", "Topology",
    "default_topology", "five_tier_topology", "get_topology",
]
