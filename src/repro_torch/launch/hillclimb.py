"""Hillclimbing driver: one candidate change to a chosen (arch x shape) cell,
dry-run on the single-pod mesh, its roofline terms printed (the
counterpart of ``repro/launch/hillclimb.py``).  Results append to
``results/perf/<cell>.jsonl``.

Cells:
  qwen-prefill    qwen1.5-32b at prefill_32k
  jamba-train     jamba-1.5-large-398b at train_4k
  mixtral-decode  mixtral-8x7b at decode_32k (the serving tier)

Variants: ``serve_replicated`` (weights replicated over "data"),
``seqshard`` / ``serve_seqshard`` / ``train_seqshard`` (sequence-parallel
activations), ``cap1.0`` (MoE capacity factor 1.0), ``loss_chunk`` (the
loss over 256-token chunks), ``bf16_grads`` (gradients cast to bf16); any
other name runs the baseline.

Usage (CPU only):
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --cell mixtral-decode --variant serve_replicated
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun, roofline as rl, specs
from repro_torch.launch.mesh import make_production_mesh

CELLS = {
    "qwen-prefill": ("qwen1.5-32b", "prefill_32k"),
    "jamba-train": ("jamba-1.5-large-398b", "train_4k"),
    "mixtral-decode": ("mixtral-8x7b", "decode_32k"),
}


def _shape(name):
    return next(s for s in SHAPES if s.name == name)


def run_variant(cell_name: str, variant: str,
                outdir: str = "results/perf") -> dict:
    arch_id, shape_name = CELLS[cell_name]
    arch = get_arch(arch_id)
    cell = _shape(shape_name)
    mesh = make_production_mesh()
    act_profile = "train" if cell.step == "train" else "serve"

    if variant == "cap1.0":
        arch = dataclasses.replace(
            arch, full=dataclasses.replace(arch.full, capacity_factor=1.0))
    if variant == "loss_chunk":
        arch = dataclasses.replace(
            arch, full=dataclasses.replace(arch.full, loss_chunk=256))
    if cell.step == "train":
        tcfg = None
        if variant == "bf16_grads":
            from repro_torch.training.grad_compression import \
                CompressionConfig
            _, tcfg = specs.train_config_for(arch)
            tcfg = dataclasses.replace(
                tcfg, compression=CompressionConfig(mode="bf16"))

        def build(n):
            return specs.build_train_cell(arch, cell, n, tcfg)
        if "seqshard" in variant:
            act_profile = "train_seqshard"
    else:
        profile = "serve_replicated" if "repl" in variant else "serve"

        def build(n):
            return specs.build_cell(arch, cell, profile, n)
        if "seqshard" in variant:
            act_profile = "serve_seqshard"

    t0 = time.time()
    traced = dryrun.trace_cell(arch, cell, act_profile=act_profile,
                               build_fn=build)
    stats, args = dryrun.resolve_cell(traced, mesh, act_profile)
    roof = rl.analyze(stats, traced["cell"].meta, cell.step, mesh.size,
                      args)
    rec = {"cell": cell_name, "variant": variant,
           "wall_s": time.time() - t0,
           "compute_s": roof.compute_s, "memory_s": roof.memory_s,
           "collective_s": roof.collective_s, "dominant": roof.dominant,
           "useful": roof.useful_ratio,
           "coll_counts": roof.collectives["counts"],
           "coll_bytes": roof.collectives["out_bytes"],
           "args_gb": args / 1e9,
           "temp_gb": roof.memory_analysis["temp_size_in_bytes"] / 1e9}
    print(f"[{cell_name}|{variant}] compute={roof.compute_s:.4f}s "
          f"memory={roof.memory_s:.4f}s "
          f"collective={roof.collective_s:.4f}s dominant={roof.dominant} "
          f"useful={roof.useful_ratio:.3f} args={rec['args_gb']:.2f}GB "
          f"temp={rec['temp_gb']:.2f}GB")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, f"{cell_name}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--variant", required=True)
    ap.add_argument("--outdir", default="results/perf")
    a = ap.parse_args()
    run_variant(a.cell, a.variant, a.outdir)


if __name__ == "__main__":
    main()
