"""Logical-axis sharding: rules mapping logical names to mesh axes (the port
of ``repro/sharding.py``).

Model code names every parameter, cache and activation dimension with a
*logical* axis ("embed", "heads", "mlp", "experts", "act_batch", ...); the
``*_specs`` functions of :mod:`repro_torch.models` return those names.
This module resolves them against a mesh with a *rule profile*, with two
safety valves applied per tensor dimension:

  * **divisibility**: a rule applies only if the dimension divides by the
    mesh axis size (40 heads on a 16-way axis replicate instead of failing);
  * **no axis reuse**: within one spec each mesh axis is used at most once,
    the first dimension winning (so ``act_batch -> data`` on a batch-1
    decode falls through and ``act_kv -> data`` picks the axis up instead:
    the long_500k cache layout).

A mesh here is either a device-free :class:`Mesh` (axis names and sizes,
like jax's ``AbstractMesh``: the dry run resolves the production meshes
without 512 devices) or a real ``torch.distributed`` ``DeviceMesh``.  A
resolved spec is a :class:`P`, a tuple with one entry per leading tensor
dimension: None (replicated), a mesh-axis name, or a tuple of names
(trailing Nones dropped, as jax's ``PartitionSpec`` compares).
:func:`to_placements` turns one into ``torch.distributed.tensor``
placements on a ``DeviceMesh``.

Activation constraints (:func:`constrain_act`, :func:`constrain_named`)
are the identity on a plain tensor unless :class:`activation_constraints`
is installed; then a DTensor is redistributed to the resolved layout and a
plain tensor is handed to the context's recorder (the dry run's cost
counter, :mod:`repro_torch.launch.op_cost`, which notes the logical
layout there and resolves it per mesh).
"""
from __future__ import annotations

import contextvars
import dataclasses
import math


# logical axis -> preferred mesh axis, per profile.  Order of dims in a
# tensor decides conflicts (first dim claims the mesh axis).
RULE_PROFILES: dict[str, dict[str, str | tuple[str, ...] | None]] = {
    "serve": {
        "vocab": "model",
        "embed": "data",           # 2D params: jamba-398B needs > 16-way
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "layers": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "act_batch": "data",
        "act_kv": "data",          # picked up when act_batch can't shard
        "act_capacity": "data",    # MoE dispatch-buffer capacity dim
    },
    "train": {
        "vocab": "model",
        "embed": "data",           # FSDP-ish second axis for params
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "layers": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "act_batch": "data",
        "act_kv": None,
        "act_capacity": "data",    # MoE dispatch-buffer capacity dim
    },
}

# Hillclimb levers (repro_torch.launch.hillclimb):
# serve_replicated: weights replicated over "data" (no per-step weight
#   all-gather for decode; only for archs whose params fit one chip at
#   1/16 model sharding).
RULE_PROFILES["serve_replicated"] = dict(RULE_PROFILES["serve"],
                                         embed=None, vocab="model")
# serve_seqshard: sequence-parallel activations, attention/MLP rows split
# over "model" (the lever for archs whose heads don't divide the axis).
RULE_PROFILES["serve_seqshard"] = dict(RULE_PROFILES["serve"],
                                       act_seq="model")
RULE_PROFILES["train_seqshard"] = dict(RULE_PROFILES["train"],
                                       act_seq="model")
# capshard: the MoE dispatch buffer's capacity dim pinned over "data";
# opt-in.
RULE_PROFILES["train_capshard"] = dict(RULE_PROFILES["train"],
                                       act_capacity="data")
# fleet: the closed-loop engine's 1-D cell mesh: every fleet leaf leads
# with the cell axis R and everything else replicates
# (repro_torch.api.shard.ShardSpec substitutes its own axis name).
RULE_PROFILES["fleet"] = {"cells": "cells"}


# ---------------------------------------------------------------------------
# Meshes and specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device-free mesh: axis names and their sizes (row-major, the
    first axis slowest)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for "
                             f"{self.axis_names} axes")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a :class:`Mesh` or a ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def mesh_size(mesh) -> int:
    return math.prod(mesh_sizes(mesh).values())


class P(tuple):
    """A resolved partition spec: one entry per leading tensor dimension
    (None, a mesh-axis name or a tuple of names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch shards over (the pod axis joins data)."""
    names = tuple(mesh_sizes(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axis) -> int:
    """The number of shards an entry gives (1 for None)."""
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def resolve_spec(shape: tuple[int, ...], logical: tuple, rules: dict,
                 mesh, batch_over_pod: bool = True) -> P:
    """Resolve one tensor's logical names to a spec."""
    names = tuple(mesh_sizes(mesh))
    used: set[str] = set()
    entries = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name is not None else None
        # batch dims additionally shard over the pod axis when present
        if (name == "act_batch" and batch_over_pod
                and "pod" in names and axis is not None):
            axis = tuple(a for a in ("pod", axis) if a not in used)
            if len(axis) == 1:
                axis = axis[0]
        if axis is None:
            entries.append(None)
            continue
        flat = axis if isinstance(axis, tuple) else (axis,)
        flat = tuple(a for a in flat if a not in used)
        size = axis_size(mesh, flat if len(flat) > 1 else
                         (flat[0] if flat else None))
        if not flat or dim % max(size, 1) != 0:
            entries.append(None)
            continue
        used.update(flat)
        entries.append(flat if len(flat) > 1 else flat[0])
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def leaf_shape(leaf) -> tuple[int, ...]:
    """The shape of a leaf: a tensor (or anything with ``.shape``), a shape
    tuple, or a stacked leaf kept as a list of layer rows ((L,) + the
    row's shape, as the reference stacks it)."""
    if isinstance(leaf, list):
        return (len(leaf),) + leaf_shape(leaf[0])
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf)


def is_spec(node) -> bool:
    """A logical spec leaf: a plain tuple of names (None, a str, or a tuple
    of str)."""
    return (type(node) is tuple
            and all(e is None or isinstance(e, (str, tuple)) for e in node))


def map_specs(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over the spec leaves of ``spec_tree``, with the
    matching nodes of ``trees`` (dicts by key, named tuples and lists by
    position); a None spec node stays None."""
    if spec_tree is None:
        return None
    if is_spec(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(map_specs(fn, v, *(t[i] for t in trees))
                                 for i, v in enumerate(spec_tree)))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, v, *(t[i] for t in trees))
                               for i, v in enumerate(spec_tree))
    raise TypeError(f"not a spec tree node: {spec_tree!r}")


def resolve_tree(shape_tree, spec_tree, profile: str, mesh):
    """Shape and logical-spec trees -> a tree of resolved specs of the spec
    tree's structure."""
    rules = RULE_PROFILES[profile]

    def leaf(spec, shape_leaf):
        shape = leaf_shape(shape_leaf)
        assert len(shape) == len(spec), (shape, spec)
        return resolve_spec(shape, spec, rules, mesh)

    return map_specs(leaf, spec_tree, shape_tree)


def batch_spec(mesh, shape: tuple[int, ...]) -> P:
    """An input batch leaf: leading dim over (pod, data), the rest
    replicated; replicated whole when the batch does not divide."""
    axes = batch_axes(mesh)
    size = axis_size(mesh, axes) if axes else 1
    if axes and shape and shape[0] % size == 0:
        return P(axes if len(axes) > 1 else axes[0])
    return P()


def batch_sharding(mesh, batch_shape_tree):
    """:func:`batch_spec` of every leaf of a dict of batch leaves."""
    return {k: batch_spec(mesh, leaf_shape(v))
            for k, v in batch_shape_tree.items()}


def replicated(mesh) -> P:
    return P()


def shard_shape(shape: tuple[int, ...], spec: tuple, mesh
                ) -> tuple[int, ...]:
    """The per-device (local) shape of a tensor of ``shape`` laid out by
    the resolved ``spec`` on ``mesh``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = axis_size(mesh, entry)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"by {entry} ({n})")
        out[i] //= n
    return tuple(out)


def to_placements(spec: tuple, device_mesh) -> tuple:
    """``torch.distributed.tensor`` placements of a resolved spec on a
    ``DeviceMesh`` with named dims: ``Shard(d)`` on each mesh dim that
    tensor dim d is laid over, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(device_mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


# ---------------------------------------------------------------------------
# Activation sharding constraints (a context installed around a step)
# ---------------------------------------------------------------------------
_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_ctx", default=None)


class activation_constraints:
    """Context manager enabling activation constraints.

    ``mesh`` resolves them for DTensors; ``record(x, logical)``, when
    given, is called with each plain tensor and its logical names and
    returns the tensor to go on with (the dry run's cost counter, which
    resolves the names per mesh; ``mesh`` may then be None)."""

    def __init__(self, mesh, profile: str = "train", record=None):
        self.mesh = mesh
        self.rules = RULE_PROFILES[profile]
        self.record = record

    def __enter__(self):
        self._tok = _ACT_CTX.set(self)
        return self

    def __exit__(self, *exc):
        _ACT_CTX.reset(self._tok)
        return False


def _constrain(x, logical: tuple):
    ctx = _ACT_CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        spec = resolve_spec(tuple(x.shape), logical, ctx.rules, x.device_mesh)
        return x.redistribute(x.device_mesh,
                              to_placements(spec, x.device_mesh))
    if ctx.record is not None:
        return ctx.record(x, logical)
    return x


def constrain_named(x, logical: tuple):
    """Constrain a tensor by explicit logical axis names (the identity
    without a context).  The reference's MoE dispatch uses it under
    ``REPRO_MOE_PIN`` on its (experts, capacity, embed) buffers; the port's
    dispatch packs its rows with no expert axis and pins nothing."""
    return _constrain(x, tuple(logical))


def act_logical(ndim: int, rules: dict) -> tuple:
    """The logical names of an activation (B, S, ...) under ``rules``:
    batch, and the sequence under a seqshard profile."""
    logical = ["act_batch"] + [None] * (ndim - 1)
    if ndim >= 2 and rules.get("act_seq"):
        logical[1] = "act_seq"
    return tuple(logical)


def constrain_act(x):
    """Constrain an activation (B, S, ...) to the profile's batch/seq rules
    (the identity without a context)."""
    ctx = _ACT_CTX.get()
    if ctx is None:
        return x
    return _constrain(x, act_logical(x.ndim, ctx.rules))
