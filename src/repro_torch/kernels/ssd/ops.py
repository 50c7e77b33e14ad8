"""Public SSD entry point of the port (``repro/kernels/ssd/ops.py``).

The device of the tensors decides: CPU tensors run the plain version
(:func:`.ref.ssd_chunked`), CUDA tensors launch kernel B6 or raise
(:mod:`.ssd`).  Serving reaches the SSD scan only through here; training
calls :func:`.ref.ssd_chunked` directly, and this entry point raises when
an input needs gradients (:func:`..refuse_grad`).  On the ``meta`` device
(the dry run) the plain version stands in for the kernel
(:func:`..stand_in`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad, stand_in
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.kernels.ssd.ssd import ssd_scan


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int = 256,
        init_state: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: x (B, S, H, P); dt (B, S, H) positive; a (H,)
    negative; b/c (B, S, G, N).  Returns (y, final_state)."""
    refuse_grad("ops.ssd", "repro_torch.kernels.ssd.ref.ssd_chunked", x, dt,
                a, b, c, init_state)
    if x.device.type == "meta":
        return stand_in("ssd_scan", lambda: ssd_chunked(
            x, dt, a, b, c, chunk, init_state), x, dt, a, b, c)
    return ssd_scan(x, dt, a, b, c, chunk, init_state)
