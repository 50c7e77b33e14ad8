"""Wrappers of the fused fleet EFE kernel (``csrc/efe_fleet.cu``).

Two entry points, one CUDA source (a template switch):

* :func:`belief_efe_fleet` — belief update fused with the EFE over every
  action, replacing ``repro/kernels/efe/efe.py::belief_efe_fleet_pallas``;
* :func:`efe_fleet` — the EFE alone, replacing ``efe_fleet_pallas``.

For tensors on the CPU each wrapper runs the plain PyTorch version
(:mod:`repro_torch.kernels.efe.ref`).  For CUDA tensors it checks device,
dtype (float32), shapes and contiguity, launches the kernel on the current
stream and raises if the launch reports an error — there is no fallback.
Each wrapper counts its kernel launches in its ``launches`` attribute.
The library is built with ``nvcc`` at the first CUDA call
(:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.efe import ref

SOURCES = ("efe_fleet.cu",)
_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first use)."""
    lib = build.load("efe_fleet", SOURCES)
    lib.belief_efe_fleet_launch.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.belief_efe_fleet_launch.restype = _I
    lib.efe_fleet_launch.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.efe_fleet_launch.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(nb, q, na, logc, amb, cost, obs_mask):
    dev = nb.device
    r, a, s, s2 = nb.shape
    if s2 != s:
        raise ValueError(f"nb must be (R, A, S, S), got {tuple(nb.shape)}")
    m, nbin = na.shape[1], na.shape[2]
    _check("nb", nb, (r, a, s, s), dev)
    _check("q", q, (r, s), dev)
    _check("na", na, (r, m, nbin, s), dev)
    _check("logc", logc, (r, m, nbin), dev)
    _check("amb", amb, (r, s), dev)
    _check("cost", cost, (a,), dev)
    if obs_mask is not None:
        _check("obs_mask", obs_mask, (r, m), dev)
    return r, a, s, m, nbin


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def belief_efe_fleet(nb: torch.Tensor, prev_action: torch.Tensor,
                     q_prev: torch.Tensor, loglik: torch.Tensor,
                     na: torch.Tensor, logc: torch.Tensor, amb: torch.Tensor,
                     cost: torch.Tensor, obs_mask: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused belief update → EFE: (G (R, A), posterior (R, S)).

    ``nb`` (R, A, S, S) is the cached normalized transition stack and
    ``prev_action`` (R,) the applied action: the kernel reads
    ``nb[r, prev_action[r]]`` in place as B_prev.  ``loglik`` (R, S) arrives
    mask-zeroed; ``obs_mask`` ((R, M) float 0/1, optional) additionally
    drops masked modalities from the risk term.  See :mod:`.ref` for the
    remaining operands.
    """
    if nb.device.type == "cpu":
        return ref.belief_efe_fleet_ref(
            ref.gather_prev_b(nb, prev_action), q_prev, loglik, nb, na, logc,
            amb, cost, obs_mask)
    if nb.device.type != "cuda":
        raise ValueError(f"no kernel for device {nb.device}")
    r, a, s, m, nbin = _check_common(nb, q_prev, na, logc, amb, cost,
                                     obs_mask)
    _check("loglik", loglik, (r, s), nb.device)
    _check("prev_action", prev_action, (r,), nb.device, torch.int64)
    g = torch.empty((r, a), device=nb.device)
    q = torch.empty((r, s), device=nb.device)
    rc = library().belief_efe_fleet_launch(
        nb.data_ptr(), prev_action.data_ptr(), q_prev.data_ptr(),
        loglik.data_ptr(), na.data_ptr(), logc.data_ptr(), amb.data_ptr(),
        cost.data_ptr(), _ptr(obs_mask), g.data_ptr(), q.data_ptr(),
        r, a, s, m, nbin, torch.cuda.current_stream(nb.device).cuda_stream)
    _raise_on(rc, "belief_efe_fleet")
    belief_efe_fleet.launches += 1
    return g, q


def efe_fleet(nb: torch.Tensor, q: torch.Tensor, na: torch.Tensor,
              logc: torch.Tensor, amb: torch.Tensor, cost: torch.Tensor,
              obs_mask: torch.Tensor | None = None) -> torch.Tensor:
    """G (R, A) of the beliefs ``q`` (R, S); operands as in :mod:`.ref`."""
    if nb.device.type == "cpu":
        return ref.efe_fleet_ref(nb, q, na, logc, amb, cost, obs_mask)
    if nb.device.type != "cuda":
        raise ValueError(f"no kernel for device {nb.device}")
    r, a, s, m, nbin = _check_common(nb, q, na, logc, amb, cost, obs_mask)
    g = torch.empty((r, a), device=nb.device)
    rc = library().efe_fleet_launch(
        nb.data_ptr(), q.data_ptr(), na.data_ptr(), logc.data_ptr(),
        amb.data_ptr(), cost.data_ptr(), _ptr(obs_mask), g.data_ptr(),
        r, a, s, m, nbin, torch.cuda.current_stream(nb.device).cuda_stream)
    _raise_on(rc, "efe_fleet")
    efe_fleet.launches += 1
    return g


belief_efe_fleet.launches = 0
efe_fleet.launches = 0
