"""Wrapper of the SSD chunked-scan kernel B6 (``csrc/ssd_scan.cu``), which
replaces ``repro/kernels/ssd/ssd.py::ssd_pallas`` and, on the model path,
the oracle ``repro/models/ssm.py::ssd_chunked`` that the reference calls.

For tensors on the CPU :func:`ssd_scan` runs the plain version
(:func:`repro_torch.kernels.ssd.ref.ssd_chunked`).  For CUDA tensors it
checks device, dtype (x/b/c float32 or bfloat16, dt and a float32), shapes,
contiguity and 16-byte alignment, launches the kernel on the current stream
and raises if the launch reports an error — there is no fallback.  A
bfloat16 call with a chunk of at most 256 rows and a head dim in
:data:`TC_HEAD_DIMS` takes the chunk-parallel tensor-core route (three
launches; the wrapper allocates their scratch: each chunk's cumulative
decay and state, in float32); every other call runs the float32 CUDA-core
kernel.  It counts its calls in
``ssd_scan.launches``.  The library is built with ``nvcc`` at the first
CUDA call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

SOURCES = ("ssd_scan.cu",)
STATE_DIMS = (16, 32, 64, 128, 256)
MAX_CHUNK = 1024
#: Head dims of the bf16 chunk-parallel route's kernels (for chunks of at
#: most 256 rows; ``ssd_scan_route`` in the source decides).
TC_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first use)."""
    lib = build.load("ssd_scan", SOURCES)
    lib.ssd_scan_launch.argtypes = [_P] * 10 + [_I] * 8 + [_P]
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_route.argtypes = [_I] * 3
    lib.ssd_scan_route.restype = _I
    lib.ssd_scan_smem_bytes.argtypes = [_I] * 7
    lib.ssd_scan_smem_bytes.restype = _I
    return lib


def smem_bytes(p: int, n: int, q: int, dtype: torch.dtype = torch.float32,
               h: int = 1, g: int = 1) -> dict[str, int]:
    """Dynamic shared memory of one block of each kernel a call launches
    (head dim ``p``, state width ``n``, chunk length ``q``, ``h`` heads in
    ``g`` groups), by kernel name."""
    lib, dt = library(), _DTYPES[dtype]
    if not lib.ssd_scan_route(dt, p, q):
        return {"ssd_scan_kernel": lib.ssd_scan_smem_bytes(dt, p, n, q, h, g,
                                                           0)}
    return {"ssd_state_tc_kernel": lib.ssd_scan_smem_bytes(dt, p, n, q, h, g,
                                                           0),
            "ssd_pass_kernel": 0,
            "ssd_out_tc_kernel": lib.ssd_scan_smem_bytes(dt, p, n, q, h, g, 2)}


def _check(x, dt, a, b, c, init_state) -> None:
    if x.ndim != 4 or b.ndim != 4 or tuple(b.shape) != tuple(c.shape):
        raise ValueError(f"expected x (B, S, H, P) and b/c (B, S, G, N), got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if tuple(b.shape[:2]) != (bsz, s) or g == 0 or h % g:
        raise ValueError(f"b/c {tuple(b.shape)} do not fit x {tuple(x.shape)}"
                         f" (H must be a multiple of G)")
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,):
        raise ValueError(f"expected dt ({bsz}, {s}, {h}) and a ({h},), got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if p % 16 or n not in STATE_DIMS:
        raise ValueError(f"head dim {p} must be a multiple of 16 and state "
                         f"width {n} one of {STATE_DIMS}")
    if init_state is not None and tuple(init_state.shape) != (bsz, h, p, n):
        raise ValueError(f"init_state has shape {tuple(init_state.shape)}, "
                         f"expected {(bsz, h, p, n)}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c),
                    ("init_state", init_state)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share float32 or bfloat16, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32, got {dt.dtype}, "
                        f"{a.dtype}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernel "
                             f"stages tiles with 16-byte loads)")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H) positive; a (H,) negative; b/c
    (B, S, G, N); chunk Q; init_state optional (B, H, P, N).  Returns
    (y (B, S, H, P), final_state (B, H, P, N)) in x's type."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, a, b, c, chunk, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, dt, a, b, c, init_state)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(int(chunk), s)
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must lie in [1, {MAX_CHUNK}]")
    init = (None if init_state is None
            else init_state.to(torch.float32).contiguous())
    y = torch.empty_like(x)
    st = torch.empty((bsz, h, p, n), dtype=x.dtype, device=x.device)
    lib = library()
    cs_scratch = st_scratch = None
    if lib.ssd_scan_route(_DTYPES[x.dtype], p, q):
        nc = -(-s // q)
        cs_scratch = torch.empty(bsz * nc * q * h, dtype=torch.float32,
                                 device=x.device)
        st_scratch = torch.empty(bsz * nc * h * p * n, dtype=torch.float32,
                                 device=x.device)
    rc = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if init is None else init.data_ptr(), y.data_ptr(), st.data_ptr(),
        None if cs_scratch is None else cs_scratch.data_ptr(),
        None if st_scratch is None else st_scratch.data_ptr(),
        _DTYPES[x.dtype], bsz, s, h, p, g, n, q,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    return y, st


ssd_scan.launches = 0
