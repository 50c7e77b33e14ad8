"""AIF-routed multi-tier model serving on the PyTorch/CUDA port (the
port's counterpart of ``serve_multitier.py``).

Three ServingEngines host small/medium/large variants of a transformer
(the datacenter analogue of the paper's Jetson/desktop tiers); real
batched requests flow through continuous-batching decode; the Active
Inference router splits traffic from aggregated observations only.  The
tiers' heads are d_model / 4: 8, 12 and 16 columns.  On the card every
prefill's attention is kernel B4 and every decode wave's kernel B5
(``csrc/flash_attn.cu``) at those head dims, in float32.

    PYTHONPATH=src python examples/serve_multitier_torch.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse

import numpy as np

from repro_torch.core import DiscretizationConfig
from repro_torch.device import resolve_device
from repro_torch.envsim.routers import AifRouter
from repro_torch.models import ModelConfig
from repro_torch.serving import MultiTierServer, ServingEngine, TierRuntime


def make_engine(name, n_layers, d_model, max_batch, steps, device):
    cfg = ModelConfig(name=name, family="dense", n_layers=n_layers,
                      d_model=d_model, n_heads=4, n_kv_heads=2,
                      d_ff=2 * d_model, vocab_size=256,
                      param_dtype="float32", compute_dtype="float32")
    return TierRuntime(ServingEngine(cfg, max_batch=max_batch, max_len=64,
                                     name=name, device=device),
                       steps_per_tick=steps)


def main(argv=None) -> list[str]:
    """Run the example; returns the lines it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the engines and the router live "
                         "(default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line=""):
        print(line, flush=True)
        lines.append(line)

    tiers = [
        make_engine("light", 2, 32, max_batch=2, steps=1,       # Jetson-ish
                    device=device),
        make_engine("medium", 2, 48, max_batch=3, steps=1, device=device),
        make_engine("heavy", 2, 64, max_batch=8, steps=3,       # desktop-ish
                    device=device),
    ]
    disc = DiscretizationConfig(latency_edges_s=(3.0, 6.0),
                                rps_edges=(3.0, 6.0),
                                queue_edges=(3.0, 10.0))
    router = AifRouter(disc=disc, seed=0, device=device)
    srv = MultiTierServer(tiers, router, slo_ticks=8, seed=0)
    out = srv.run(n_ticks=60, arrival_rate=4.0, prompt_len=16,
                  max_new_tokens=4, vocab=256)

    say(f"completed {out['completed']} requests")
    say(f"latency P50 {out['p50_ticks']:.1f} ticks, "
        f"P95 {out['p95_ticks']:.1f} ticks, "
        f"SLO violations {100*out['slo_violation_rate']:.1f}%")
    say(f"routed share L/M/H:    "
        f"{np.round(out['tier_routed']/max(out['tier_routed'].sum(),1), 3)}")
    say(f"mean router weights:   {np.round(out['mean_weights'], 3)}")
    say(f"late-phase weights:    {np.round(out['late_weights'], 3)} "
        f"(learning shifts toward the high-capacity tier)")
    return lines


if __name__ == "__main__":
    main()
