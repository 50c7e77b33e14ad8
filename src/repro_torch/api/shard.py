"""Device sharding of the fleet's cell axis: :class:`ShardSpec`.

The closed-loop engine advances a fleet of R independent service cells,
the one axis of the program with no coupling until the final metric
reduction (and, on a graph world, the spillover exchange).
:class:`ShardSpec` names how that axis maps onto local devices: how many,
and what happens when R does not divide by their count.

The engine is single-controller, as the reference's ``shard_map`` program
is: one process and one host loop drive every shard, each shard holding a
contiguous block of rows on its device.  :meth:`ShardSpec.build_mesh` is
the list of those devices (the reference's ``make_cell_mesh``), and
:func:`split_rows` / :func:`gather_rows` move a tree of tensors between
the whole fleet and its row blocks (leading axis split, scalars
replicated: the reference's "fleet" partition rule).  A collective becomes
a copy in shard order and a sum in a fixed order, so results never depend
on timing.

Padding rule (``pad="pad"``, the default): R is rounded up to the next
multiple of the shard count; the phantom cells get zero traffic, inert
restart draws and are left out of every reduction
(:func:`repro_torch.envsim.scenarios.pad_scenario`).  ``pad="strict"``
raises instead.

The engine's sharded entry points also take ``mesh=``, a list of devices
that overrides :meth:`ShardSpec.build_mesh`: ``mesh=[device] * 4`` lays four
shards on one device, the port's counterpart of the reference's virtual CPU
mesh, for tests and for holding a sharded run against an unsharded one on
one card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import sharding as sharding_mod
from repro_torch.device import resolve_device

#: Name of the fleet's cell axis (the reference's mesh-axis name).
CELLS = "cells"


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How the cell axis R maps onto local devices (frozen, hashable).

    Args:
      devices: devices to shard over; None takes every local device of the
        run's device type.
      axis: name of the cell axis (kept for the reference's signature).
      pad: ``"pad"`` rounds R up to a device multiple with inert phantom
        cells; ``"strict"`` raises when R does not divide.
    """

    devices: int | None = None
    axis: str = CELLS
    pad: str = "pad"

    def __post_init__(self):
        if self.pad not in ("pad", "strict"):
            raise ValueError(
                f"pad policy must be 'pad' or 'strict', got {self.pad!r}")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")

    def n_devices(self, device: str | torch.device = "cuda") -> int:
        """The device count, checked against the local devices of
        ``device``'s type."""
        # local devices of that type (one CPU)
        avail = (torch.cuda.device_count()
                 if torch.device(device).type == "cuda" else 1)
        n = avail if self.devices is None else self.devices
        if n > avail or n < 1:
            raise ValueError(
                f"ShardSpec wants {n} devices but {avail} "
                f"{torch.device(device).type} devices are local; to lay "
                f"several shards on one device, pass mesh=[device] * n to "
                f"the engine's sharded entry points")
        return n

    def padded(self, n_cells: int, n_shards: int | None = None,
               device: str | torch.device = "cuda") -> tuple[int, int]:
        """(R padded to a multiple of the shard count, cells per shard).

        ``n_shards`` None counts :meth:`n_devices` of ``device``.  The
        ``"strict"`` policy raises on an R that does not divide.  Pad rows
        are phantom cells with zero arrivals and zero hazard, left out of
        every fleet reduction; a fleet graph is built at the *true* R, so
        they stay edge-less.
        """
        d = self.n_devices(device) if n_shards is None else int(n_shards)
        rem = n_cells % d
        if rem and self.pad == "strict":
            raise ValueError(
                f"R={n_cells} is not divisible by {d} devices and the shard "
                f"spec is strict; use pad='pad' (default) or pick R as a "
                f"device multiple")
        r_pad = n_cells + (d - rem if rem else 0)
        return r_pad, r_pad // d

    def build_mesh(self, device: str | torch.device = "cuda"
                   ) -> list[torch.device]:
        """The shards' devices in shard order: the first
        :meth:`n_devices` devices of ``device``'s type."""
        dev = resolve_device(device)
        n = self.n_devices(dev)
        if dev.type != "cuda":
            return [dev] * n
        return [torch.device("cuda", i) for i in range(n)]

    # ----------------------------------------------------- partition specs
    def leaf_spec(self, leaf, mesh) -> sharding_mod.P:
        """The spec of one leaf: its leading cell axis on this spec's mesh
        axis.  Resolved through :func:`repro_torch.sharding.resolve_spec`
        with a one-rule profile mapping the logical ``cells`` name onto
        ``self.axis``, so the divisibility valve applies (a leaf whose
        leading dim cannot split replicates; scalars replicate).  ``mesh``
        is a :class:`repro_torch.sharding.Mesh` or a ``DeviceMesh``."""
        shape = tuple(getattr(leaf, "shape", ()))
        logical = (CELLS,) + (None,) * (len(shape) - 1) if shape else ()
        rules = (sharding_mod.RULE_PROFILES["fleet"] if self.axis == CELLS
                 else {CELLS: self.axis})
        return sharding_mod.resolve_spec(shape, logical, rules, mesh)

    def tree_specs(self, tree, mesh):
        """The tree with every tensor leaf replaced by its
        :meth:`leaf_spec`."""
        return _map(lambda leaf: self.leaf_spec(leaf, mesh), tree)


def resolve(shard) -> ShardSpec | None:
    """Normalize an ``Experiment.shard``-style argument: None stays None
    (unsharded), ``"auto"`` means every local device, a
    :class:`ShardSpec` passes through."""
    if shard is None or isinstance(shard, ShardSpec):
        return shard
    if shard == "auto":
        return ShardSpec()
    raise ValueError(
        f"shard must be None, 'auto' or a ShardSpec, got {shard!r}")


def _map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor leaf (None leaves and
    Python scalars pass through)."""
    if tree is None or isinstance(tree, (int, float, bool, str)):
        return tree
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    raise TypeError(f"cannot shard a leaf of type {type(tree).__name__}")


def split_rows(tree, mesh: list[torch.device], r_local: int) -> list:
    """One tree per shard: each tensor leaf's leading axis, the padded
    fleet, cut into ``len(mesh)`` blocks of ``r_local`` rows, each on its
    shard's device; a 0-d leaf is replicated.  On the same device a block
    is a view of the leaf."""
    r_pad = r_local * len(mesh)

    def block(d):
        lo = d * r_local

        def cut(x):
            if x.ndim:
                if x.shape[0] != r_pad:
                    raise ValueError(
                        f"a leaf of shape {tuple(x.shape)} has no leading "
                        f"axis of the padded fleet size {r_pad}")
                x = x[lo:lo + r_local]
            return x.to(mesh[d])
        return cut

    return [_map(block(d), tree) for d in range(len(mesh))]


def gather_rows(trees: list, device: torch.device):
    """The fleet tree from its shards' trees (the inverse of
    :func:`split_rows`): row blocks concatenated in shard order on
    ``device``; a 0-d leaf is taken from the first shard."""
    first = trees[0]
    if first is None or isinstance(first, (int, float, bool, str)):
        return first
    if isinstance(first, torch.Tensor):
        if first.ndim == 0:
            return first.to(device)
        return torch.cat([x.to(device) for x in trees])
    if isinstance(first, dict):
        return {k: gather_rows([t[k] for t in trees], device)
                for k in first}
    parts = [gather_rows(list(p), device) for p in zip(*trees)]
    return type(first)(*parts) if hasattr(first, "_fields") else \
        type(first)(parts)
