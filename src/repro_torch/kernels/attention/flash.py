"""Wrappers of the flash attention kernels (``csrc/flash_attn.cu``).

* :func:`flash_prefill` (kernel B4) replaces
  ``repro/kernels/attention/flash.py::flash_prefill``: online-softmax GQA
  attention with causal / sliding-window masks by absolute position and a
  ``q_offset``; key tiles the mask hides are skipped.  bfloat16 runs both
  products on the tensor cores (``prefill_tc_kernel``), float32 on the
  CUDA cores (``prefill_kernel``).
* :func:`flash_decode` (kernel B5) replaces ``flash_decode``: one query
  token per sequence against a KV cache, causal to a per-batch
  ``position`` with an optional window.  The cache splits into chunks of
  :func:`decode_chunk` keys, one block per (chunk, KV head, sequence)
  writing a float32 partial to scratch, and a merge kernel joins them: two
  kernels, one launch as ``launches`` counts.

For tensors on the CPU each wrapper runs its plain version
(:mod:`repro_torch.kernels.attention.ref`).  For CUDA tensors it checks
device, dtype (float32 or bfloat16), shapes, contiguity and 16-byte
alignment, launches the kernel on the current stream and raises if the
launch reports an error — there is no fallback.  Each wrapper counts its launches in ``launches``:
its calls, so a call recorded into a CUDA graph counts once, when it is
recorded, and the graph's replays, which run no wrapper, not at all (a
device trace counts their kernels by name).
The library is built with ``nvcc`` at the first CUDA call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import ref

SOURCES = ("flash_attn.cu",)
HEAD_DIMS = (8, 12, 16, 32, 64, 128, 256)
# Streaming multiprocessors of an H100 (SXM5), the one card the port
# targets.
H100_SMS = 132
# B5 cuts the cache so that about this many blocks (live or not) run: six
# a streaming multiprocessor, so that a wave whose positions reach only
# part of the cache still fills the card.
DECODE_TARGET_BLOCKS = 6 * H100_SMS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first use)."""
    lib = build.load("flash_attn", SOURCES)
    lib.flash_prefill_launch.argtypes = [_P] * 4 + [_I] * 10 + [_P]
    lib.flash_prefill_launch.restype = _I
    lib.flash_decode_launch.argtypes = [_P] * 6 + [_I] * 8 + [_P]
    lib.flash_decode_launch.restype = _I
    lib.flash_attn_smem_bytes.argtypes = [_I] * 3
    lib.flash_attn_smem_bytes.restype = _I
    return lib


_SMEM_KERNELS = {("prefill", torch.float32): 0, ("prefill", torch.bfloat16): 1,
                 ("decode", torch.float32): 2, ("decode", torch.bfloat16): 3}


def smem_bytes(kernel: str, d: int, group: int = 1,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory one block of ``kernel`` ("prefill", or
    "decode" with ``group`` query heads per KV head) takes in ``dtype``."""
    return library().flash_attn_smem_bytes(_SMEM_KERNELS[kernel, dtype], d,
                                           group)


def decode_chunk(b: int, s: int, hkv: int) -> int:
    """Keys per chunk of B5's split: a multiple of 16 such that about
    :data:`DECODE_TARGET_BLOCKS` blocks cover the (b, s, hkv) cache.  It
    depends on the shapes only, never on the positions."""
    n = max(1, _ceil_div(DECODE_TARGET_BLOCKS, b * hkv))
    return max(16, 16 * _ceil_div(_ceil_div(s, n), 16))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"expected q (B, Sq, Hq, D) and k/v (B, Skv, Hkv, D),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; q, k and v must "
                            f"share float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the "
                             f"kernels stage tiles with 16-byte loads)")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D); query row i
    sits at absolute position ``q_offset + i``, key j at j."""
    if q.device.type == "cpu":
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_qkv(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    rc = library().flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], b, sq, skv, hq, hkv, d, int(causal), int(window),
        int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_prefill")
    flash_prefill.launches += 1
    return o


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 position: int | torch.Tensor,
                 window: int = 0) -> torch.Tensor:
    """q (B, 1, Hq, D) against a cache k/v (B, S, Hkv, D) -> (B, 1, Hq, D),
    causal to ``position`` — an int (broadcast) or a (B,) tensor of each
    sequence's own position — with an optional window."""
    if q.device.type == "cpu":
        return ref.decode_ref(q, k, v, position=position, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_qkv(q, k, v)
    b, one, hq, d = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query token, got Sq={one}")
    s, hkv = k.shape[1], k.shape[2]
    if isinstance(position, torch.Tensor) and position.ndim > 0:
        if tuple(position.shape) != (b,):
            raise ValueError(f"position has shape {tuple(position.shape)}, "
                             f"expected ({b},)")
        pos = position.to(q.device, torch.int32).contiguous()
    else:
        pos = torch.full((b,), int(position), dtype=torch.int32,
                         device=q.device)
    chunk = decode_chunk(b, s, hkv)
    n_split = _ceil_div(s, chunk)
    part = torch.empty(b * hkv * n_split * (hq // hkv) * (d + 2),
                       dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    rc = library().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        pos.data_ptr(), part.data_ptr(), _DTYPES[q.dtype], b, s, hq, hkv, d,
        int(window), chunk, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_decode")
    flash_decode.launches += 1
    return o


flash_prefill.launches = 0
flash_decode.launches = 0
