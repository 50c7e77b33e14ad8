"""AIF core of the port: topology, policies, spaces, generative model,
belief, learning, agent state and the fused fleet tick."""
from repro_torch.core.generative import AifConfig
from repro_torch.core.spaces import DiscretizationConfig
from repro_torch.core.topology import (TOPOLOGIES, PolicySpec, Topology,
                                       default_topology, five_tier_topology,
                                       get_topology)

__all__ = ["AifConfig", "DiscretizationConfig", "TOPOLOGIES", "PolicySpec",
           "Topology", "default_topology", "five_tier_topology",
           "get_topology"]
