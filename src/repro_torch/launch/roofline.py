"""Roofline terms of a dry-run cell on NVIDIA H100 SXM cards (the
counterpart of ``repro/launch/roofline.py``, whose constants are a TPU's).

Hardware model, per card, H100 SXM datasheet values (not measured here):
  * 989e12 FLOP/s dense bf16 tensor-core peak; 67e12 FLOP/s fp32 for a
    step whose compute type is float32;
  * 3.35e12 B/s HBM3;
  * 450e9 B/s NVLink per direction inside an 8-card node, 50e9 B/s
    (400 Gb/s InfiniBand) per card across nodes; a collective goes at the
    rate of the slowest link its group crosses
    (:func:`repro_torch.launch.op_cost.link_class`);
  * 80 GB of device memory.

Terms per (arch, shape, mesh):
  compute    = FLOPs_per_card / peak
  memory     = HBM_bytes_per_card / 3.35e12
  collective = NVLink_bytes / 450e9 + InfiniBand_bytes / 50e9
FLOPs, bytes and collectives come from :mod:`repro_torch.launch.op_cost`.
"""
from __future__ import annotations

import dataclasses

#: Datasheet peaks of an H100 SXM card.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 50e9
HBM_BYTES = 80e9


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    link_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (cards * per-card FLOPs)
    collectives: dict
    memory_analysis: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_for(meta: dict, cell_step: str) -> float:
    """Napkin MODEL_FLOPS: 6 N_active T for training, 2 N_active T for a
    forward-only step."""
    n = meta["active_params"]
    t = meta["tokens"]
    return (6.0 if cell_step == "train" else 2.0) * n * t


def analyze(stats, meta: dict, step: str, n_chips: int,
            argument_bytes: float) -> Roofline:
    """The roofline of a cell from its per-card
    :class:`repro_torch.launch.op_cost.Stats` and argument bytes."""
    peak = PEAK_FLOPS[meta.get("compute_dtype", "bfloat16")]
    compute_s = stats.flops / peak
    memory_s = stats.hbm_bytes / HBM_BW
    collective_s = (stats.link_bytes_nvlink / NVLINK_BW
                    + stats.link_bytes_ib / IB_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_for(meta, step)
    mem = {"argument_size_in_bytes": argument_bytes,
           "output_size_in_bytes": stats.output_bytes,
           "temp_size_in_bytes": stats.peak_bytes,
           "fits": argument_bytes + stats.peak_bytes <= HBM_BYTES,
           "hbm_bytes": HBM_BYTES}
    return Roofline(
        flops_per_chip=stats.flops,
        hbm_bytes_per_chip=stats.hbm_bytes,
        link_bytes_per_chip=stats.link_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf,
        useful_ratio=mf / max(stats.flops * n_chips, 1.0),
        collectives={"counts": stats.coll_counts,
                     "out_bytes": stats.coll_bytes,
                     "link_bytes": stats.link_bytes,
                     "link_bytes_nvlink": stats.link_bytes_nvlink,
                     "link_bytes_ib": stats.link_bytes_ib,
                     "launches": stats.launches,
                     "kernel_flops": stats.kernel_flops},
        memory_analysis=mem)
