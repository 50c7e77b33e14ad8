"""Production meshes (the counterpart of ``repro/launch/mesh.py``).

Single pod: (16, 16) = ("data", "model"), 256 cards.  Multi-pod: (2, 16,
16) = ("pod", "data", "model"), 512 cards; the "pod" axis carries data
parallelism across the slowest links.  The dry run needs no devices for
them: :func:`make_production_mesh` returns a device-free
:class:`repro_torch.sharding.Mesh`.  :func:`make_debug_mesh` is a real
``torch.distributed`` ``DeviceMesh`` over the devices present, and
:func:`make_cell_mesh` the fleet engine's device list.
"""
from __future__ import annotations

import os
import socket

import torch

from repro_torch.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_debug_mesh(data: int = 1, model: int = 1,
                    device: str = "cuda"):
    """A ``DeviceMesh`` of shape (data, model) named ("data", "model") over
    the first data*model devices of ``device``'s type.  Without a process
    group it starts one in this process (rank 0 of data*model, NCCL on the
    card, gloo on the CPU, at ``tcp://localhost`` on a free port): on one
    H100 that is the (1, 1) mesh, since NCCL refuses two ranks on one card.
    The caller destroys the group
    (``torch.distributed.destroy_process_group()``) when done."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = data * model
    if not dist.is_initialized():
        backend = "nccl" if device == "cuda" else "gloo"
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=n, rank=int(os.environ.get("RANK", "0")))
    if dist.get_world_size() != n:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


def make_cell_mesh(n_devices: int | None = None, device: str = "cuda"
                   ) -> list[torch.device]:
    """The fleet's cell axis: the first ``n_devices`` local devices of
    ``device``'s type (all of them for None), as
    :meth:`repro_torch.api.shard.ShardSpec.build_mesh` lays shards."""
    from repro_torch.api.shard import ShardSpec
    return ShardSpec(devices=n_devices).build_mesh(device)
