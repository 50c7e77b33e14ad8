"""A dry-run cell's top FLOP, HBM-byte and link-byte contributors, as the
port counts them on the ``meta`` device (the port's counterpart of
``tools/debug_bytes.py``, which reads XLA's HLO of the same cell).

    PYTHONPATH=src python tools/debug_bytes_torch.py ARCH SHAPE PROFILE

ARCH and SHAPE name a cell of the registry (``internlm2-1.8b
prefill_32k``); PROFILE is the rule profile of a serving cell's parameters
and caches (``serve``, ``serve_replicated``, ``serve_seqshard``; a train
cell takes the train profile whatever it says).  The cell is counted as
``python -m repro_torch.launch.dryrun`` counts it (per period, and per
microbatch in training) on the (16, 16) production mesh, and the script
prints the top 12 per card: FLOPs and HBM bytes by op (the aten op and the
parameter leaf it reads, or a kernel's name), and every collective (kind,
the rule's op and the leaf behind it, group axes and size, bytes a device,
times a step, link bytes).  No JAX, no card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402


MESH = "single"   # the (16, 16) production mesh
TOP = 12


def contributors(arch_id: str, shape: str, profile: str) -> op_cost.Stats:
    """The whole cell's per-card :class:`~repro_torch.launch.op_cost.Stats`
    on the production mesh, with its itemized FLOPs, bytes and
    collectives."""
    arch = get_arch(arch_id)
    cell = next(s for s in SHAPES if s.name == shape)
    parts = [(dryrun.run_job(job), w, pw)
             for job, w, pw in dryrun.cell_jobs(arch, cell, [MESH],
                                                profile=profile)]
    return dryrun.combine(parts, MESH)


def report(st: op_cost.Stats) -> list[str]:
    """The lines the script prints."""
    lines = [f"total FLOPs {st.flops:.4e}  HBM bytes {st.hbm_bytes:.4e}  "
             f"link bytes {st.link_bytes:.4e} (NVLink "
             f"{st.link_bytes_nvlink:.4e}, IB {st.link_bytes_ib:.4e})"]
    for title, table in (("FLOPs", st.op_flops), ("HBM bytes", st.op_bytes)):
        lines.append(f"-- top {title} by op")
        rows = sorted(((v, k) for k, v in table.items() if v), reverse=True)
        lines += [f"{v:.3e}  {k}" for v, k in rows[:TOP]]
    lines.append("-- top link bytes by collective")
    for i in op_cost.collective_items(st)[:TOP]:
        if i["times"]:
            lines.append(
                f"{i['link_bytes']:.3e}  {i['kind']:<14} x{i['times']:g}  "
                f"{i['bytes']:.3e} B over {'/'.join(i['axes'])} "
                f"({i['group']})  {i['source']}")
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("arch")
    ap.add_argument("shape", choices=[s.name for s in SHAPES])
    ap.add_argument("profile")
    a = ap.parse_args(argv)
    lines = report(contributors(a.arch, a.shape, a.profile))
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
