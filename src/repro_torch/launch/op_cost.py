"""Per-device cost of a step, counted from its aten ops (the counterpart of
``repro/launch/hlo_cost.py``).

The reference reads XLA's optimized per-partition HLO.  The port has no
HLO: it runs its own step, usually on the ``meta`` device (shapes and
types, no storage), under a ``TorchDispatchMode`` that records every aten
op (:func:`trace`), and then resolves the record against a mesh
(:func:`resolve`).  One record serves every mesh.  These are the port's
numbers, not XLA's: eager PyTorch has no fusions, and the sharded program
is modelled, not compiled, by the rules below.

**The sharded program** is FSDP over the batch axes ("pod", "data") and
tensor parallelism over the other axes ("model"), as PyTorch shards.  Each
tensor of the record carries a *layout*: the set of mesh axes it is divided
over on one device.

1. Inputs take their resolved specs (:mod:`repro_torch.sharding`):
   parameters their profile's, optimizer state the train profile's,
   caches the serve profile's, batch leaves :func:`sharding.batch_spec`
   (the batch over "pod" and "data" when it divides, else replicated,
   as long_500k's batch of 1).  A parameter's layout in compute is its
   non-batch (tensor-parallel) axes: FSDP gathers its batch-axis shards
   before use; its storage layout counts toward the argument bytes.
2. A tensor made without inputs is replicated, unless its leading
   dimension is the batch B (or a microbatch's rows) or the tokens B*S:
   then it takes the batch layout.
3. Any other op: its output's layout is the union of its inputs'.  Its
   FLOPs divide by the union's size; its bytes are each operand's and
   output's bytes divided by that tensor's own layout size.
4. A matmul (mm, addmm, bmm, baddbmm, _grouped_mm) whose
   parameter-derived operand is split over tensor-parallel axes A along
   a contracted dimension: the output drops A and is all-reduced over A
   (the row-parallel output, and the column-parallel input's gradient).
   Parameter-derived means a parameter or a view or cast of one; its
   dimensions are followed through those.
5. A bmm or a grouped product whose parameter-derived operand is split
   over axes A along its batch (expert) dimension while the other operand
   is not: that operand is all-to-all'd over A and keeps A from then on
   (the MoE dispatch).
6. A lookup (aten.index) into a parameter split over A along the indexed
   dimension: the output takes the indices' layout and is all-reduced over
   A (the vocab-parallel embedding).  A lookup into an activation whose
   tensor-parallel axes A the indices lack: the output drops A and is
   all-to-all'd over A (the MoE combine); an elementwise gather
   (aten.gather) all-reduces instead.  A scatter whose values carry
   tensor-parallel axes the destination lacks all-to-alls the values.
7. A kernel's plain version standing in for its launch on ``meta``
   (:func:`repro_torch.kernels.stand_in`): its matmul FLOPs count (as the
   kernel's, by name, and in the total); its bytes are the kernel's own,
   inputs read once and outputs written once, and its intermediates are
   not allocated.  Its outputs take its first input's layout (q, x); any
   axes its other inputs carry beyond that one's (a cache split on its
   sequence by ``act_kv``) split its work too, and its output is
   all-reduced over them.
8. :func:`repro_torch.sharding.constrain_act` / ``constrain_named`` set a
   tensor's layout, and its gradient's, to the resolved logical names.
9. Per step, from the parameter specs: a leaf split over batch axes is
   all-gathered over them (its tensor-parallel shard) once per forward,
   twice per microbatch in training (forward and backward), and its
   gradient reduce-scattered once per microbatch; a leaf replicated over
   the batch axes has its gradient all-reduced over them once per
   microbatch.
10. Ring link bytes per device, as ``repro/launch/roofline.py`` counts:
    all-reduce 2N(k-1)/k, all-gather N(k-1)/k, reduce-scatter N_out(k-1),
    all-to-all N(k-1)/k, N the per-device bytes and k the group size.
    Each collective is filed under NVLink when its group fits one 8-card
    node (:func:`link_class`), else InfiniBand.
11. Live bytes: every op output with storage of its own is allocated at
    its per-device size and freed when its storage dies; the step's
    temporary peak is the highest sum.

The resolved :class:`Stats` also itemize: every collective by kind, the
rule's op and the parameter leaf behind it, its group and bytes
(:func:`collective_items`), and FLOPs and HBM bytes by op
(``tools/debug_bytes_torch.py`` prints the top of each).

FLOPs are matmul-class only, by ``torch.utils.flop_counter``'s formulas
(2mnk for a product), as the reference counts dots only; a grouped
product (the MoE's experts over packed rows) counts every row of its
jagged operand, the rows past its last offset too, since a trace on
``meta`` has no offsets to read.  A reduction over
a split dimension (a softmax over vocab-split logits, the grouped keys of
GQA attention when the KV heads do not divide the axis) is not followed:
its output keeps the union layout until a rule above or a constraint
resets it, so such ops can be under-counted by the axis size.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import kernels, sharding

aten = torch.ops.aten

# (a's arg index, b's arg index, a's contracted dim, b's contracted dim,
#  batch dim or None)
_MATMUL = {aten.mm: (0, 1, 1, 0, None), aten.addmm: (1, 2, 1, 0, None),
           aten.bmm: (0, 1, 2, 1, 0), aten.baddbmm: (1, 2, 2, 1, 0)}
_SCATTER = {aten.index_put_, aten.index_put, aten._index_put_impl_,
            aten.index_add_, aten.index_add, aten.scatter_add_,
            aten.scatter_add, aten.scatter_, aten.scatter}
#: Nodes with this many cards share NVLink; larger groups cross nodes.
NODE_CARDS = 8


def _grouped_dims(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``_MATMUL``'s entry for a grouped product: b (G, K, N) holds the
    groups in its batch dimension; with both operands 2-D the groups cut
    the contracted dimension."""
    return (0, 1, a.dim() - 1, b.dim() - 2, 0 if b.dim() == 3 else None)


def _grouped_mm_flops(a, b, *args, out_val=None, **kwargs) -> int:
    """2 x the multiply-adds of ``aten._grouped_mm`` over every row of its
    jagged operand: (M, K) x (G, K, N), (P, T) x (T, Q) cut along T, and
    (G, M, K) x (G, K, N) take 2 a.numel() N; (G, M, K) x (K, N) cut along
    N takes 2 M K N."""
    if a.dim() == 3 and b.dim() == 2:
        return 2 * a.shape[1] * a.shape[2] * b.shape[1]
    return 2 * a.numel() * b.shape[-1]


def _flop_formula(packet):
    if packet == aten._grouped_mm:
        return _grouped_mm_flops
    return flop_registry.get(packet)


# op record kinds
_OP, _INPLACE, _VIEW, _MM, _INDEX, _GATHER, _FACTORY, _ALLOC, _FREE, \
    _CONSTRAIN, _KBEGIN, _KEND = range(12)


@dataclasses.dataclass
class Input:
    """How one input of the step is laid out: its logical names resolved
    on ``shape`` (the stacked leaf's shape for a layer row, whose first
    entry, "layers", is then dropped) under ``profile``; ``role`` is
    "param", "state", "cache" or "batch" (batch leaves resolve by
    :func:`sharding.batch_spec` instead)."""

    logical: tuple
    shape: tuple
    row: bool
    profile: str
    role: str
    name: str = ""              # the leaf's path, for the itemized record


@dataclasses.dataclass
class Trace:
    """The record of one step: its ops and tensors, at one device."""

    nbytes: list = dataclasses.field(default_factory=list)
    shapes: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)
    inputs: dict = dataclasses.field(default_factory=dict)
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    outputs: list = dataclasses.field(default_factory=list)
    train_gathers: int = 0        # FSDP gathers of a leaf a microbatch
    microbatches: int = 0         # microbatches a step (rule 9)


@dataclasses.dataclass
class Stats:
    """Per-device totals of a step on a mesh."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    link_bytes: float = 0.0
    link_bytes_nvlink: float = 0.0
    link_bytes_ib: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    kernel_flops: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    output_bytes: float = 0.0
    #: The itemized collectives: (kind, source, group axes, group size,
    #: per-device bytes) -> how many times a step; the source names the
    #: rule's op and the parameter leaf behind it (:func:`collective_items`)
    collectives: dict = dataclasses.field(default_factory=dict)
    #: FLOPs and HBM bytes by op: the aten op and the parameter leaf it
    #: reads ("mm: stack/pos0/mlp/wi"), or a kernel's name
    op_flops: dict = dataclasses.field(default_factory=dict)
    op_bytes: dict = dataclasses.field(default_factory=dict)

    def combine(self, other: "Stats", mult: float = 1.0) -> "Stats":
        """``self + mult * other``, field by field (the peak too)."""
        out = Stats()
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, dict):
                keys = set(a) | set(b)
                setattr(out, f.name, {k: a.get(k, 0) + mult * b.get(k, 0)
                                      for k in keys})
            else:
                setattr(out, f.name, a + mult * b)
        return out


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------
def _dtype_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _reshape_map(a: tuple, b: tuple) -> tuple:
    """For a reshape of shape a to b: each output dim's source dim (the
    first non-trivial input dim of its group, on the group's first
    non-trivial output dim) or None."""
    out: list = [None] * len(b)
    i = j = 0
    while i < len(a) and j < len(b):
        ia, jb = i, j
        pa, pb = a[i], b[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb and i < len(a):
                pa *= a[i]
                i += 1
            elif j < len(b):
                pb *= b[j]
                j += 1
            else:
                return tuple(out)
        src = next((k for k in range(ia, i) if a[k] > 1), None)
        dst = next((k for k in range(jb, j) if b[k] > 1), None)
        if src is not None and dst is not None:
            out[dst] = src
    return tuple(out)


def _dim(d: int, n: int) -> int:
    return d + n if d < 0 else d


def _view_map(func, args, inp: torch.Tensor, out: torch.Tensor):
    """Each output dim's source dim for a view or same-shape op of one
    tensor, or None when the op is not followed."""
    packet = func.overloadpacket
    n_in, shape_in, shape_out = inp.ndim, tuple(inp.shape), tuple(out.shape)
    if packet in (aten.t, aten.numpy_T):
        return tuple(range(n_in))[::-1]
    if packet == aten.transpose:
        d0, d1 = _dim(args[1], n_in), _dim(args[2], n_in)
        m = list(range(n_in))
        m[d0], m[d1] = m[d1], m[d0]
        return tuple(m)
    if packet == aten.permute:
        return tuple(_dim(d, n_in) for d in args[1])
    if packet == aten.expand:
        lead = out.ndim - n_in
        return (None,) * lead + tuple(range(n_in))
    if packet == aten.unsqueeze:
        d = _dim(args[1], out.ndim)
        return tuple(range(d)) + (None,) + tuple(range(d, n_in))
    if packet == aten.select:
        d = _dim(args[1], n_in)
        return tuple(k for k in range(n_in) if k != d)
    if shape_in == shape_out:
        return tuple(range(n_in))
    if out.numel() == inp.numel():
        return _reshape_map(shape_in, shape_out)
    if out.ndim == n_in:              # slice, narrow
        return tuple(range(n_in))
    return None


def _tensors(args, kwargs) -> list:
    """The tensors of an op's arguments (one level of lists, as aten
    schemas nest them)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += [x for x in a if isinstance(x, torch.Tensor)]
    return out


def _alias(func) -> str | None:
    rets = func._schema.returns
    if not rets or rets[0].alias_info is None:
        return None
    return "inplace" if rets[0].alias_info.is_write else "view"


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace, batch_rows: tuple[int, ...]):
        super().__init__()
        self.t = trace
        self.batch_rows = batch_rows
        self.ids = WeakIdKeyDictionary()
        self.storages = WeakIdKeyDictionary()
        self.kernel_depth = 0

    # -- tensors -----------------------------------------------------------
    def rec(self, t: torch.Tensor) -> int:
        r = self.ids.get(t)
        if r is None:
            r = self.new(t)
        return r

    def new(self, t: torch.Tensor) -> int:
        r = len(self.t.nbytes)
        self.t.nbytes.append(_dtype_bytes(t))
        self.t.shapes.append(tuple(t.shape))
        self.ids[t] = r
        return r

    def alloc(self, t: torch.Tensor, r: int) -> None:
        st = t.untyped_storage()
        if st in self.storages:
            return
        self.storages[st] = r
        ops = self.t.ops
        ops.append((_ALLOC, r))
        weakref.finalize(st, ops.append, (_FREE, r))

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_in = _tensors(args, kwargs)
        flat_out = ([out] if isinstance(out, torch.Tensor)
                    else _tensors(out, {}) if isinstance(out, (list, tuple))
                    else [])
        packet = func.overloadpacket
        formula = _flop_formula(packet)
        flops = (float(formula(*args, **kwargs, out_val=out))
                 if formula is not None else 0.0)
        ins = tuple(self.rec(a) for a in flat_in)
        alias = _alias(func)
        ops = self.t.ops
        if alias == "inplace":
            # the output is the mutated input: same record, no allocation
            for o in flat_out:
                if o not in self.ids:
                    self.ids[o] = ins[0]
            ops.append((_INPLACE, flops, ins, packet in _SCATTER,
                        packet.__name__))
            return out
        outs = tuple(self.new(o) for o in flat_out)
        if alias == "view":
            m = (_view_map(func, args, flat_in[0], flat_out[0])
                 if len(outs) == 1 else None)
            if packet == aten.unbind:
                d = _dim(args[1] if len(args) > 1 else 0, flat_in[0].ndim)
                m = tuple(k for k in range(flat_in[0].ndim) if k != d)
            ops.append((_VIEW, ins[0], outs, m))
            return out
        if not ins:
            lead = bool(flat_out and flat_out[0].ndim
                        and flat_out[0].shape[0] in self.batch_rows)
            ops.append((_FACTORY, outs, lead))
        elif packet in _MATMUL or packet == aten._grouped_mm:
            ia, ib, ca, cb, bd = (_MATMUL[packet] if packet in _MATMUL
                                  else _grouped_dims(args[0], args[1]))
            ops.append((_MM, flops, ins, outs, self.rec(args[ia]),
                        self.rec(args[ib]), ca, cb, bd, packet.__name__))
        elif packet == aten.index and isinstance(args[1], (list, tuple)):
            dim = next(k for k, ix in enumerate(args[1]) if ix is not None)
            idx = tuple(self.rec(ix) for ix in args[1] if ix is not None)
            ops.append((_INDEX, flops, ins, outs, ins[0], idx, dim,
                        packet.__name__))
        elif packet in (aten.gather, aten.index_select):
            ops.append((_GATHER, flops, ins, outs, packet.__name__))
        else:
            m = None
            if packet == aten.stack:
                m = (None,) + tuple(range(flat_in[0].ndim))
            elif len(outs) == 1 and len(flat_in) == 1:
                m = _view_map(func, args, flat_in[0], flat_out[0])
            ops.append((_OP, flops, ins, outs, packet in _SCATTER, m,
                        packet.__name__))
        for o, r in zip(flat_out, outs):
            self.alloc(o, r)
        return out

    # -- hooks -------------------------------------------------------------
    def constrain(self, x: torch.Tensor, logical: tuple) -> torch.Tensor:
        return _Constrain.apply(x, logical, self)

    def note_constrain(self, x: torch.Tensor, logical: tuple) -> None:
        self.t.ops.append((_CONSTRAIN, self.rec(x), logical))

    def stand_in(self, name: str, plain, inputs):
        ins = tuple(self.rec(t) for t in inputs if t is not None)
        self.t.ops.append((_KBEGIN, name))
        out = plain()
        outs = tuple(self.rec(o) for o in tree_flatten(out)[0]
                     if isinstance(o, torch.Tensor))
        self.t.ops.append((_KEND, name, ins, outs))
        self.t.launches[name] += 1
        return out


class _Constrain(torch.autograd.Function):
    """The identity, noting a layout for the tensor and its gradient."""

    @staticmethod
    def forward(ctx, x, logical, recorder):
        ctx.logical, ctx.recorder = logical, recorder
        out = x.view_as(x)
        recorder.note_constrain(out, logical)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.view_as(g)
        ctx.recorder.note_constrain(out, ctx.logical)
        return out, None, None


class FlopCount(TorchDispatchMode):
    """The matmul-class FLOPs of the aten ops run under it, by the same
    formulas as :func:`trace`: for a step on a real device, where the
    whole record would cost too much host time.  Kernels launched through
    ctypes are not aten ops and are not seen."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = _flop_formula(func.overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        return out


def trace(fn, inputs: list[tuple[torch.Tensor, Input]], *,
          batch_rows: tuple[int, ...] = (), act_profile: str = "train",
          microbatches: int = 0, train_gathers: int = 0):
    """Run ``fn()`` under the recorder; returns (its result, the
    :class:`Trace`).  ``inputs`` pairs each input tensor (a parameter, a
    state or cache tensor, a batch leaf) with its :class:`Input`; a tensor
    listed twice keeps its first entry.  ``batch_rows``: leading sizes that
    mark a tensor made without inputs as batch-laid (rule 2).
    ``microbatches``/``train_gathers``: rule 9's microbatches a step and
    FSDP gathers a microbatch (0 for a serving step, which gathers
    once)."""
    t = Trace(train_gathers=train_gathers, microbatches=microbatches)
    rec = _Recorder(t, batch_rows)
    for x, desc in inputs:
        if x not in rec.ids:
            t.inputs[rec.new(x)] = desc
    token = kernels.STAND_IN.set(rec.stand_in)
    try:
        with sharding.activation_constraints(None, act_profile,
                                             record=rec.constrain):
            with rec:
                out = fn()
        t.outputs = [rec.ids.get(o) for o in tree_flatten(out)[0]
                     if isinstance(o, torch.Tensor)]
    finally:
        kernels.STAND_IN.reset(token)
    return out, t


# ---------------------------------------------------------------------------
# Resolving a record on a mesh
# ---------------------------------------------------------------------------
def link_class(mesh, axes) -> str:
    """"nvlink" when every group over ``axes`` lies in one node of
    :data:`NODE_CARDS` cards (mesh devices row-major, the last axis
    fastest), else "ib"."""
    sizes = sharding.mesh_sizes(mesh)
    names = list(sizes)
    extent = 1
    for a in axes:
        stride = math.prod(sizes[n] for n in names[names.index(a) + 1:])
        extent = max(extent, stride * sizes[a])
    return "nvlink" if extent <= NODE_CARDS else "ib"


def _entry_axes(entry) -> frozenset:
    if entry is None:
        return frozenset()
    return frozenset(entry if isinstance(entry, tuple) else (entry,))


def input_layout(desc: Input, mesh) -> tuple:
    """(per-dim mesh axes of one input, as stored) on ``mesh``."""
    if desc.role == "batch":
        spec = sharding.batch_spec(mesh, desc.shape)
    else:
        spec = sharding.resolve_spec(desc.shape, desc.logical,
                                     sharding.RULE_PROFILES[desc.profile],
                                     mesh)
    dims = [_entry_axes(e) for e in spec]
    dims += [frozenset()] * (len(desc.shape) - len(dims))
    return tuple(dims[1:] if desc.row else dims)


class _Resolver:
    def __init__(self, tr: Trace, mesh):
        self.tr, self.mesh = tr, mesh
        self.sizes = sharding.mesh_sizes(mesh)
        self.batch = frozenset(sharding.batch_axes(mesh))
        self.st = Stats(coll_counts={}, coll_bytes={}, kernel_flops={},
                        launches=dict(tr.launches))
        n = len(tr.nbytes)
        self.ax: list = [frozenset()] * n
        self.pd: list = [None] * n
        self.nm: list = [""] * n        # the parameter leaf behind a tensor
        self._size_cache: dict = {}

    def size(self, axes: frozenset) -> int:
        s = self._size_cache.get(axes)
        if s is None:
            s = math.prod(self.sizes[a] for a in axes)
            self._size_cache[axes] = s
        return s

    def local(self, r: int) -> float:
        return self.tr.nbytes[r] / self.size(self.ax[r])

    def collective(self, kind: str, n: float, axes: frozenset,
                   times: float = 1.0, source: str = "") -> None:
        k = self.size(axes)
        if k <= 1 or n <= 0:
            return
        link = ring_link_bytes(kind, n, k) * times
        st = self.st
        key = (kind, source, tuple(sorted(axes)), k, n)
        st.collectives[key] = st.collectives.get(key, 0) + times
        st.coll_counts[kind] = st.coll_counts.get(kind, 0) + times
        st.coll_bytes[kind] = st.coll_bytes.get(kind, 0.0) + n * times
        st.link_bytes += link
        if link_class(self.mesh, axes) == "nvlink":
            st.link_bytes_nvlink += link
        else:
            st.link_bytes_ib += link

    def run(self) -> Stats:
        tr, st, ax, pd = self.tr, self.st, self.ax, self.pd
        for r, desc in tr.inputs.items():
            dims = input_layout(desc, self.mesh)
            if desc.role == "param":
                tp = tuple(d - self.batch for d in dims)
                pd[r] = tp
                self.nm[r] = desc.name
                ax[r] = frozenset().union(*tp)
                self._fsdp(r, dims)
            else:
                ax[r] = frozenset().union(*dims)
        live = peak = 0.0
        counted: dict = {}
        kernel = None
        for op in tr.ops:
            kind = op[0]
            if kind == _VIEW:
                _, src, outs, m = op
                for o in outs:
                    ax[o] = ax[src]
                    self.nm[o] = self.nm[src]
                    if pd[src] is not None and m is not None:
                        pd[o] = tuple(pd[src][k] if k is not None
                                      else frozenset() for k in m)
            elif kind == _ALLOC:
                if kernel is None:
                    b = self.local(op[1])
                    counted[op[1]] = b
                    live += b
                    peak = max(peak, live)
            elif kind == _FREE:
                live -= counted.pop(op[1], 0.0)
            elif kind == _FACTORY:
                _, outs, lead = op
                for o in outs:
                    shape0 = tr.shapes[o][0] if tr.shapes[o] else 1
                    ok = lead and shape0 % self.size(self.batch) == 0
                    ax[o] = self.batch if ok else frozenset()
            elif kind == _CONSTRAIN:
                _, r, logical = op
                spec = sharding.resolve_spec(
                    tr.shapes[r], logical, self.rules, self.mesh)
                ax[r] = frozenset().union(*(_entry_axes(e) for e in spec))
                pd[r] = None
            elif kind == _KBEGIN:
                kernel = op[1]
            elif kind == _KEND:
                self._kernel_end(op)
                kernel = None
            else:
                self._op(op, kernel)
        st.peak_bytes = peak
        st.output_bytes = sum(self.local(r) for r in tr.outputs
                              if r is not None)
        return st

    def _union(self, ins) -> frozenset:
        ax, pd = self.ax, self.pd
        param_only = all(pd[r] is not None for r in ins)
        out = frozenset()
        for r in ins:
            out |= ax[r]
        return out, param_only

    def _op(self, op, kernel) -> None:
        st, ax, pd = self.st, self.ax, self.pd
        kind, flops, ins = op[0], op[1], op[2]
        leaf = next((self.nm[r] for r in ins if self.nm[r]), "")
        label = kernel or (f"{op[-1]}: {leaf}" if leaf else op[-1])
        if kind == _MM:
            _, _, _, outs, a, b, ca, cb, bd, _ = op
            if bd is not None and pd[b] is not None and pd[a] is None:
                missing = pd[b][0] - ax[a]
                if missing:   # rule 5: the expert dispatch
                    self.collective("all-to-all", self.local(a), missing,
                                    source=f"bmm dispatch: {self.nm[b]}")
                    ax[a] = ax[a] | missing
        union, param_only = self._union(ins)
        split = self.size(union)
        if flops:
            st.flops += flops / split
            st.op_flops[label] = st.op_flops.get(label, 0.0) + flops / split
            if kernel is not None:
                st.kernel_flops[kernel] = (st.kernel_flops.get(kernel, 0.0)
                                           + flops / split)
        if kind == _INPLACE:
            if op[3] and kernel is None:
                self._scatter(ins)
            if kernel is None:
                self._bytes(label, sum(self.local(r) for r in ins)
                            + self.local(ins[0]))
            return
        outs = op[3]
        out_ax = union
        if kind == _MM:
            a, b, ca, cb = op[4], op[5], op[6], op[7]
            contracted = frozenset()
            if pd[a] is not None and ca < len(pd[a]):
                contracted |= pd[a][ca]
            if pd[b] is not None and cb < len(pd[b]):
                contracted |= pd[b][cb]
            contracted &= union
            out_ax = union - contracted
            for o in outs:
                ax[o] = out_ax
            if contracted:    # rule 4: the row-parallel all-reduce
                self.collective("all-reduce", sum(
                    self.local(o) for o in outs), contracted,
                    source="matmul, contracted split: "
                    + (self.nm[a] or self.nm[b]))
        elif kind == _INDEX:
            src, idx, dim = op[4], op[5], op[6]
            idx_ax = frozenset().union(*(ax[r] for r in idx))
            if pd[src] is not None:      # rule 6: vocab-parallel lookup
                split_ax = pd[src][dim] if dim < len(pd[src]) else frozenset()
                rest = frozenset().union(*(d for k, d in enumerate(pd[src])
                                           if k != dim))
                out_ax = idx_ax | rest
                for o in outs:
                    ax[o] = out_ax
                self.collective("all-reduce", sum(
                    self.local(o) for o in outs), split_ax,
                    source=f"lookup: {self.nm[src]}")
            else:
                moved = (ax[src] - idx_ax) - self.batch
                out_ax = (ax[src] | idx_ax) - moved
                for o in outs:
                    ax[o] = out_ax
                self.collective("all-to-all", sum(
                    self.local(o) for o in outs), moved,
                    source="lookup into an activation")
        elif kind == _GATHER:
            for o in outs:
                ax[o] = union
        else:
            m = op[5]
            for o in outs:
                ax[o] = union
                if param_only and ins:
                    self.nm[o] = self.nm[ins[0]]
                if param_only and m is not None and ins and \
                        pd[ins[0]] is not None:
                    pd[o] = tuple(pd[ins[0]][k] if k is not None
                                  else frozenset() for k in m)
            if op[4] and kernel is None:
                self._scatter(ins)
        if kernel is None:
            self._bytes(label, sum(self.local(r) for r in ins)
                        + sum(self.local(o) for o in outs))

    def _bytes(self, label: str, n: float) -> None:
        st = self.st
        st.hbm_bytes += n
        st.op_bytes[label] = st.op_bytes.get(label, 0.0) + n

    def _scatter(self, ins) -> None:
        """Rule 6's scatter: values with tensor-parallel axes the
        destination lacks are all-to-all'd."""
        dest = ins[0]
        for v in ins[1:]:
            moved = (self.ax[v] - self.ax[dest]) - self.batch
            if moved and self.tr.nbytes[v] > 8:
                self.collective("all-to-all", self.local(v), moved,
                                source="scatter")

    def _kernel_end(self, op) -> None:
        _, name, ins, outs = op
        ax = self.ax
        first = ax[ins[0]] if ins else frozenset()
        extra = frozenset().union(*(ax[r] for r in ins[1:])) - first
        for o in outs:
            ax[o] = first
            self.pd[o] = None
        self._bytes(name, sum(self.local(r) for r in ins)
                    + sum(self.local(o) for o in outs))
        if extra:     # rule 7: a sequence-split cache
            self.collective("all-reduce", sum(
                self.local(o) for o in outs), extra,
                source=f"{name}: split cache")

    def _fsdp(self, r: int, dims: tuple) -> None:
        """Rule 9 for one parameter."""
        tr = self.tr
        bat = frozenset().union(*dims) & self.batch
        tp = frozenset().union(*dims) - self.batch
        gathered = tr.nbytes[r] / self.size(tp)
        name = self.nm[r]
        if bat:
            gathers = (tr.train_gathers * tr.microbatches if tr.microbatches
                       else 1)
            self.collective("all-gather", gathered, bat, gathers,
                            source=f"fsdp gather: {name}")
            if tr.microbatches:
                self.collective("reduce-scatter", gathered / self.size(bat),
                                bat, tr.microbatches,
                                source=f"fsdp gradient: {name}")
        elif tr.microbatches:
            self.collective("all-reduce", gathered, self.batch,
                            tr.microbatches, source=f"gradient: {name}")


def ring_link_bytes(kind: str, n: float, k: int) -> float:
    """Rule 10: the link bytes a device sends for one collective of
    ``kind`` over a group of ``k`` with ``n`` bytes a device (the
    reduce-scatter's ``n`` is its output)."""
    return {"all-reduce": 2.0 * n * (k - 1) / k,
            "all-gather": n * (k - 1) / k,
            "reduce-scatter": n * (k - 1),
            "all-to-all": n * (k - 1) / k}[kind]


def collective_items(st: Stats) -> list[dict]:
    """The itemized collectives of ``st``, largest link bytes first: kind,
    source (the rule's op and the parameter leaf behind it), group axes,
    group size, per-device bytes, times a step and link bytes a step."""
    items = [dict(kind=kind, source=src, axes=list(axes), group=k, bytes=n,
                  times=times, link_bytes=ring_link_bytes(kind, n, k) * times)
             for (kind, src, axes, k, n), times in st.collectives.items()]
    return sorted(items, key=lambda i: -i["link_bytes"])


def resolve(tr: Trace, mesh, act_profile: str = "train") -> Stats:
    """The per-device :class:`Stats` of a recorded step on ``mesh`` (a
    :class:`repro_torch.sharding.Mesh` or a ``DeviceMesh``), its
    activation constraints resolved under ``act_profile``."""
    res = _Resolver(tr, mesh)
    res.rules = sharding.RULE_PROFILES[act_profile]
    return res.run()


def argument_bytes(inputs: list[tuple[tuple, torch.dtype, Input]],
                   mesh) -> float:
    """Per-device bytes of the step's arguments: each input's shape and
    type under its stored layout on ``mesh``."""
    total = 0.0
    for shape, dtype, desc in inputs:
        dims = input_layout(desc, mesh)
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        split = math.prod(sharding.mesh_sizes(mesh)[a]
                          for a in frozenset().union(*dims))
        total += n / split
    return total
