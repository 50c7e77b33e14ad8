"""Device resolution shared by every entry point that creates tensors."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to build on; raises when CUDA is asked for but
    absent, so a run meant for the card never drifts onto the CPU.  An
    explicit ``"meta"`` (shapes and types, no storage: the dry run of
    :mod:`repro_torch.launch`) is taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
