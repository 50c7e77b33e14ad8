"""Architecture registry: ``get_arch(id)`` / ``all_archs()`` / ``--arch``."""
from repro_torch.configs import (chameleon_34b, gemma3_1b, gemma_2b,
                           internlm2_1p8b, jamba_1p5_large_398b,
                           llama4_scout_17b_16e, mamba2_2p7b, mixtral_8x7b,
                           qwen1p5_32b, seamless_m4t_medium)
from repro_torch.configs.base import SHAPES, ArchSpec, ShapeCell

_ARCHS = [
    llama4_scout_17b_16e.ARCH,
    mixtral_8x7b.ARCH,
    mamba2_2p7b.ARCH,
    gemma_2b.ARCH,
    qwen1p5_32b.ARCH,
    internlm2_1p8b.ARCH,
    gemma3_1b.ARCH,
    chameleon_34b.ARCH,
    seamless_m4t_medium.ARCH,
    jamba_1p5_large_398b.ARCH,
]

REGISTRY = {a.arch_id: a for a in _ARCHS}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; know: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_archs() -> list[ArchSpec]:
    return list(_ARCHS)


__all__ = ["SHAPES", "ArchSpec", "ShapeCell", "REGISTRY", "get_arch",
           "all_archs"]
