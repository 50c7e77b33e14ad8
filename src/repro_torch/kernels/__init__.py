"""Hand-written Hopper kernels of the port and their plain PyTorch versions."""
from __future__ import annotations

import contextvars

import torch

#: The observer of the plain versions that stand in for kernel launches on
#: the ``meta`` device (the dry run's cost counter,
#: :mod:`repro_torch.launch.op_cost`), or None.
STAND_IN: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_stand_in", default=None)


def stand_in(name: str, plain, *inputs: torch.Tensor):
    """On the ``meta`` device, where no kernel launches: ``plain()``, the
    kernel's plain version, run under the installed observer, which is
    told the kernel's ``name`` and its ``inputs`` (the wrapper's launch
    count does not move)."""
    observer = STAND_IN.get()
    if observer is None:
        return plain()
    return observer(name, plain, inputs)


def refuse_grad(op: str, instead: str, *tensors: torch.Tensor) -> None:
    """Raise when an entry point with no backward gets inputs that need
    gradients.  The kernels write their outputs through raw pointers, so
    autograd would see a tensor with no history and silently give the
    weights behind it no gradient; the plain versions on the CPU would
    differentiate, so the check runs on every device alike."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{op} has no backward (its CUDA kernel writes through raw "
            f"pointers, so gradients would be lost): call {instead} for a "
            f"differentiable version, or run under torch.no_grad()")
