"""LM serving on the port: the continuous-batching engine and the
AIF-routed multi-tier server."""
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.multitier import MultiTierServer, TierRuntime

__all__ = ["Request", "ServingEngine", "MultiTierServer", "TierRuntime"]
