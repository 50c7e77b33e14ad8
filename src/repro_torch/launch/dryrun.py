"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device (the
counterpart of ``repro/launch/dryrun.py``, which lowers each cell with XLA
on 512 forced host devices).

Per (arch, shape) this script:
  1. builds the step on ``meta`` (:mod:`.specs`) and records its aten ops
     (:func:`.op_cost.trace`);
  2. for each mesh, resolves the record to per-card FLOPs, HBM bytes,
     collectives and the temporary peak (:func:`.op_cost.resolve`), and
     the arguments' per-card bytes from their resolved specs;
  3. writes the roofline terms on H100 cards (:mod:`.roofline`) and the
     memory analysis, with a ``fits`` flag against 80 GB, as one JSON per
     cell under ``--outdir``, and a summary.

Depth is counted per period, as ``hlo_cost.py`` multiplies a scan body by
its trip count: a stack of n = r*P + t layers (period P, tail t > 0; or
t = P when the period divides n, r then one less) is traced at t and t + P
layers, and every additive count is c(t) + r (c(t + P) - c(t)); the
temporary peak is extrapolated the same way.  An encoder-decoder cuts both
stacks together (period 1).  Stacks shorter than t + 2P are traced whole.
Gradient accumulation over a >= 4 microbatches is counted the same way,
from 2 and 3 (:func:`plan`; one microbatch takes another path, with no
accumulators), but for the peak, which a microbatch does not raise past
the third's (the accumulators are live from the first).  The
arguments are always counted whole.

Each record of a cut is one job; ``--jobs`` runs that many at a time in
spawned processes, each resolving its record on every mesh.

Usage (CPU only; no device is touched):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --outdir results/dryrun --jobs 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import SHAPES, all_archs, get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import op_cost, roofline as rl, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import Mesh

MESHES = ("single", "multi")


def named_mesh(name: str):
    """"single", "multi", or "one" (the (1, 1) mesh of one card)."""
    if name == "one":
        return Mesh((1, 1), ("data", "model"))
    return make_production_mesh(multi_pod=(name == "multi"))


def depth_plan(cfg) -> list[tuple[int | None, float]]:
    """[(cut depth or None for the whole stack, weight)] whose weighted
    counts sum to the whole stack's (see the module docstring)."""
    if cfg.is_encoder_decoder:
        if cfg.n_enc_layers != cfg.n_layers:
            return [(None, 1.0)]
        period, tail = 1, 0
    else:
        period, tail = cfg.period(), cfg.n_layers % cfg.period()
    first = tail or period
    if cfg.n_layers < first + 2 * period:
        return [(None, 1.0)]
    reps = (cfg.n_layers - first) / period
    return [(first, 1.0 - reps), (first + period, reps)]


def plan(cfg, accum: int = 1) -> list[tuple[int | None, int, float, float]]:
    """[(cut depth, microbatches, weight, peak weight)]: :func:`depth_plan`
    crossed with the microbatches' own (2 and 3 standing for a >= 4,
    bilinearly); the peak takes the depth weights of the largest
    microbatch count only."""
    micro = ([(accum, 1.0)] if accum <= 3
             else [(2, 3.0 - accum), (3, accum - 2.0)])
    top = max(a for a, _ in micro)
    return [(n, a, wn * wa, wn if a == top else 0.0)
            for n, wn in depth_plan(cfg) for a, wa in micro]


# ---------------------------------------------------------------------------
# One cut of one cell: a job
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Job:
    arch_id: str
    shape: tuple              # ShapeCell fields
    n_layers: int | None
    accum: int = 1
    profile: str = "serve"
    act_profile: str = "train"
    meshes: tuple = MESHES


def build(arch, cell: ShapeCell, n_layers, accum: int = 1,
          profile: str = "serve"):
    """The cell at a cut depth (and ``accum`` microbatches for training)."""
    if cell.step == "train":
        _, tcfg = specs.train_config_for(arch)
        return specs.build_train_cell(
            arch, cell, n_layers,
            dataclasses.replace(tcfg, accum_steps=accum))
    return specs.build_cell(arch, cell, profile, n_layers)


def count(c, mesh_names, act_profile: str = "train") -> dict:
    """{mesh name: per-card Stats} of one built cell's step."""
    _, tr = op_cost.trace(c.fn, c.inputs, batch_rows=c.batch_rows,
                          act_profile=act_profile,
                          microbatches=c.microbatches,
                          train_gathers=c.train_gathers)
    return {m: op_cost.resolve(tr, named_mesh(m), act_profile)
            for m in mesh_names}


def run_job(job: Job) -> dict:
    arch = get_arch(job.arch_id)
    c = build(arch, ShapeCell(*job.shape), job.n_layers, job.accum,
              job.profile)
    return count(c, job.meshes, job.act_profile)


def cell_jobs(arch, cell: ShapeCell, meshes=MESHES, accum: int = 1,
              profile: str = "serve", act_profile: str = "train"
              ) -> list[tuple[Job, float, float]]:
    """(job, weight, peak weight) of each record of one cell; a cut to a
    microbatches keeps the microbatch, B / accum rows."""
    cfg = whole_cfg(arch, cell)
    accum = accum if cell.step == "train" else 1
    rows = cell.global_batch // accum
    return [(Job(arch.arch_id, dataclasses.astuple(dataclasses.replace(
        cell, global_batch=a * rows)), n, a, profile, act_profile,
        tuple(meshes)), w, pw) for n, a, w, pw in plan(cfg, accum)]


def run_all(jobs: list[Job], workers: int = 1, meanwhile=None) -> dict:
    """{job: its result or the exception it raised}, ``workers`` at a time
    in spawned processes (the longest first: a training step's record
    grows with its layers times its microbatches).  ``meanwhile()``, if
    given, runs in this process while they do."""
    order = sorted(set(jobs), key=lambda j: -(
        (j.n_layers or get_arch(j.arch_id).full.n_layers) * j.accum
        * (8 if j.shape[3] == "train" else 1)))
    if workers <= 1:
        if meanwhile is not None:
            meanwhile()
        return {j: _safe(j) for j in order}
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(_safe, j) for j in order]
        if meanwhile is not None:
            meanwhile()
        return {j: f.result() for j, f in zip(order, futures)}


def _safe(job: Job):
    try:
        return run_job(job)
    except Exception as e:
        return RuntimeError(f"{type(e).__name__}: {e}\n"
                            f"{traceback.format_exc()[-3000:]}")


def combine(parts: list[tuple[dict, float, float]], mesh: str
            ) -> op_cost.Stats:
    """The whole step's Stats on ``mesh`` from its records' (result,
    weight, peak weight)."""
    total = op_cost.Stats()
    for res, w, _ in parts:
        total = total.combine(res[mesh], w)
    total.peak_bytes = sum(res[mesh].peak_bytes * pw for res, _, pw in parts)
    return total


# ---------------------------------------------------------------------------
# In process (tests, hillclimb)
# ---------------------------------------------------------------------------
def trace_cell(arch, cell, profile: str = "serve",
               act_profile: str = "train", build_fn=None) -> dict:
    """The records of one (arch, shape) step at its cut depths, with the
    whole cell's arguments: ``{"plan": [(weight, Trace)], "cell": the
    whole Cell, "trace_s": seconds}``.  ``build_fn(n_layers)`` overrides
    :func:`build`."""
    build_fn = build_fn or (lambda n: build(arch, cell, n, 1, profile))
    t0 = time.time()
    whole = build_fn(None)
    cfg = whole_cfg(arch, cell)
    out = []
    for n_layers, weight in depth_plan(cfg):
        c = whole if n_layers is None else build_fn(n_layers)
        _, tr = op_cost.trace(c.fn, c.inputs, batch_rows=c.batch_rows,
                              act_profile=act_profile,
                              microbatches=c.microbatches,
                              train_gathers=c.train_gathers)
        out.append((weight, tr))
    return {"plan": out, "cell": whole, "trace_s": time.time() - t0}


def resolve_cell(traced: dict, mesh, act_profile: str = "train"
                 ) -> tuple[op_cost.Stats, float]:
    """(per-card Stats of the whole step, per-card argument bytes) on
    ``mesh``."""
    total = op_cost.Stats()
    for weight, tr in traced["plan"]:
        total = total.combine(op_cost.resolve(tr, mesh, act_profile), weight)
    args = op_cost.argument_bytes(specs.arguments(traced["cell"]), mesh)
    return total, args


def whole_cfg(arch, cell: ShapeCell):
    if cell.step == "train":
        return specs.train_config_for(arch)[0]
    return arch.full


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------
def record(arch, cell: ShapeCell, mesh_name: str, stats: op_cost.Stats,
           whole, wall_s: float) -> dict:
    """The JSON record of one cell on one mesh."""
    mesh = named_mesh(mesh_name)
    args = op_cost.argument_bytes(specs.arguments(whole), mesh)
    roof = rl.analyze(stats, whole.meta, cell.step, mesh.size, args)
    return {"arch": arch.arch_id, "shape": cell.name, "mesh": mesh_name,
            "step": cell.step, "ok": True, "wall_s": wall_s,
            "depth_plan": plan(whole_cfg(arch, cell)),
            "meta": whole.meta, "roofline": roof.as_dict()}


def summary_line(rec: dict) -> str:
    """One line of a cell: per-card argument and temp GB, FLOPs, the three
    terms and the dominant one."""
    tag = f"[{rec['arch']}|{rec['shape']}|{rec.get('mesh', '-')}]"
    if rec.get("ok") is None:
        return f"{tag} SKIP: {rec['skip']}"
    if not rec["ok"]:
        return f"{tag} FAIL {rec['error'].splitlines()[0]}"
    r = rec["roofline"]
    ma = r["memory_analysis"]
    return (f"{tag} args={ma['argument_size_in_bytes'] / 1e9:.4f}GB "
            f"temp={ma['temp_size_in_bytes'] / 1e9:.4f}GB "
            f"fits={ma['fits']} flops/card={r['flops_per_chip']:.4e} "
            f"compute={r['compute_s'] * 1e3:.4f}ms "
            f"memory={r['memory_s'] * 1e3:.4f}ms "
            f"collective={r['collective_s'] * 1e3:.4f}ms "
            f"dominant={r['dominant']}")


def cells(arch: str = "all", shape: str = "all",
          include_skipped: bool = False):
    """(the (arch, shape) cells to run, skip records) as the reference's
    ``cells()`` / ``skipped_cells()`` give them."""
    archs = all_archs() if arch == "all" else [get_arch(arch)]
    work, skips = [], []
    for a in archs:
        ok = list(a.cells())
        skipped = dict(a.skipped_cells())
        for sh in SHAPES:
            if shape not in ("all", sh.name):
                continue
            if sh in skipped and not include_skipped:
                skips.append({"arch": a.arch_id, "shape": sh.name,
                              "ok": None, "skip": skipped[sh]})
            elif sh in ok or include_skipped:
                work.append((a, sh))
    return work, skips


def sweep(arch: str = "all", shape: str = "all", mesh: str = "both",
          outdir: str | None = "results/dryrun",
          include_skipped: bool = False, workers: int = 1, echo=print,
          extra_jobs: list[Job] = (), meanwhile=None
          ) -> tuple[list[dict], dict]:
    """Every cell (and a skip record for each skipped one): (records, the
    results of ``extra_jobs``, run in the same pool); ``meanwhile`` as
    :func:`run_all` takes it."""
    mesh_names = list(MESHES) if mesh == "both" else [mesh]
    work, results = cells(arch, shape, include_skipped)
    for rec in results:
        echo(summary_line(rec))
    t0 = time.time()
    planned = {(a.arch_id, sh.name): cell_jobs(a, sh, mesh_names)
               for a, sh in work}
    done = run_all([j for parts in planned.values() for j, _, _ in parts]
                   + list(extra_jobs), workers, meanwhile)
    wall = time.time() - t0
    for a, sh in work:
        parts = [(done[j], w, pw) for j, w, pw in planned[a.arch_id,
                                                          sh.name]]
        bad = [r for r, _, _ in parts if isinstance(r, Exception)]
        whole = None if bad else build(a, sh, None)
        for name in mesh_names:
            if bad:
                rec = {"arch": a.arch_id, "shape": sh.name, "mesh": name,
                       "step": sh.step, "ok": False, "error": str(bad[0])}
            else:
                try:
                    rec = record(a, sh, name, combine(parts, name), whole,
                                 wall_s=wall)
                except Exception as e:
                    rec = {"arch": a.arch_id, "shape": sh.name,
                           "mesh": name, "step": sh.step, "ok": False,
                           "error": f"{type(e).__name__}: {e}"}
            echo(summary_line(rec))
            results.append(rec)
            if outdir:
                os.makedirs(outdir, exist_ok=True)
                fn = f"{a.arch_id}__{sh.name}__{name}.json".replace("/", "_")
                with open(os.path.join(outdir, fn), "w") as f:
                    json.dump(rec, f, indent=1)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "summary.json"), "w") as f:
            json.dump(results, f, indent=1)
    return results, {j: done[j] for j in extra_jobs}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="records traced at a time, in spawned processes")
    ap.add_argument("--include-skipped", action="store_true",
                    help="also attempt cells marked skipped (debug)")
    args = ap.parse_args()
    results, _ = sweep(args.arch, args.shape, args.mesh, args.outdir,
                       args.include_skipped, args.jobs)
    ok = sum(1 for r in results if r.get("ok"))
    fail = sum(1 for r in results if r.get("ok") is False)
    skip = sum(1 for r in results if r.get("ok") is None)
    print(f"\n=== dry-run summary: {ok} ok, {fail} failed, {skip} skipped "
          f"===")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
