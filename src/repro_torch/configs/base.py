"""Arch registry: each assigned architecture = full config + smoke config.

``full`` is the exact published configuration (the port serves it on the
card, e.g. ``get_arch("internlm2-1.8b").full``).  ``smoke`` is a reduced
same-family config that runs on the CPU.  A copy of the reference's
``repro/configs``; data only.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str                 # train | prefill | decode


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    full: ModelConfig
    smoke: ModelConfig
    long_500k_ok: bool            # sub-quadratic / bounded-cache mechanism?
    skip_reason: str = ""         # documented when long_500k_ok is False
    source: str = ""

    def cells(self):
        for sh in SHAPES:
            if sh.name == "long_500k" and not self.long_500k_ok:
                continue
            yield sh

    def skipped_cells(self):
        for sh in SHAPES:
            if sh.name == "long_500k" and not self.long_500k_ok:
                yield sh, self.skip_reason
