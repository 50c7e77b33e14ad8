"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources under
``repro_torch/csrc`` into ``repro_torch/_build/<name>-<hash>/``, where the
hash covers the sources and the flags, so an edit rebuilds and an unchanged
tree reuses the library.  The C interface is loaded with ``ctypes``.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use on a machine with the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str, sources: tuple[str, ...],
                 extra_flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str, sources: tuple[str, ...],
          extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile ``sources`` (relative to ``csrc``) into ``lib<name>.so``
    with :data:`NVCC_FLAGS` plus ``extra_flags`` unless a library of the
    same hash exists; returns its path.  The compiler's
    register/shared-memory report goes to ``ptxas.log`` beside the
    library."""
    out = library_path(name, sources, extra_flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
           *(str(CSRC / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)     # atomic: concurrent builders never see a torn .so
    return out


def load(name: str, sources: tuple[str, ...],
         extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, sources, extra_flags)))
        _LOADED[name] = lib
    return lib
