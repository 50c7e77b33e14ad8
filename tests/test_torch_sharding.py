"""The port's logical-axis sharding rules against the reference's.

* the resolver's three properties (``tests/test_sharding_launch.py``'s
  twins): divisibility fallback, first dimension wins an axis, and every
  resolved spec legal (hypothesis);
* for every arch of the registry, full and smoke: the port's parameter,
  cache and optimizer-state specs (AdamW with a float32 master, Adafactor)
  equal the reference's leaf for leaf, and resolve to equal specs under
  every rule profile on the (16, 16) and (2, 16, 16) production meshes,
  the reference resolving on a stub jax mesh of repeated CPU devices;
* ``ShardSpec.leaf_spec`` / ``tree_specs`` equal the reference's;
* the hooks: ``constrain_act`` / ``constrain_named`` are the identity on a
  plain tensor and without a context, hand the tensor to the recorder under
  one, and redistribute a DTensor; ``to_placements`` and ``shard_shape``
  agree on a one-rank gloo ``DeviceMesh``; ``resolve_device`` takes
  ``meta``.
"""
import numpy as np
import pytest
import torch
import jax
from hypothesis import given, strategies as st
from jax.sharding import Mesh as JaxMesh, PartitionSpec as JP

from repro import sharding as ref_shd
from repro.api.shard import ShardSpec as RefShardSpec
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.training import optimizer as ref_opt
from repro_torch import sharding as shd
from repro_torch.api.shard import ShardSpec
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import group_params
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import members, stacked_shape

_JAX_DTYPES = {torch.bfloat16: jax.numpy.bfloat16,
               torch.float32: jax.numpy.float32}
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def _stub_mesh(shape, names):
    """A jax mesh of one CPU device repeated (no computation launched)."""
    n = int(np.prod(shape))
    return JaxMesh(np.asarray([jax.devices()[0]] * n).reshape(shape), names)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


# --------------------------------------------------------------- resolver
def test_resolver_divisibility_fallback():
    mesh = shd.Mesh((2, 2), ("data", "model"))
    rules = {"heads": "model", "embed": "data"}
    assert shd.resolve_spec((64, 40), ("embed", "heads"), rules, mesh) == \
        shd.P("data", "model")
    assert shd.resolve_spec((64, 41), ("embed", "heads"), rules, mesh) == \
        shd.P("data")


def test_resolver_no_axis_reuse_first_dim_wins():
    mesh = shd.Mesh((2, 2), ("data", "model"))
    rules = {"act_batch": "data", "act_kv": "data"}
    assert shd.resolve_spec((8, 16), ("act_batch", "act_kv"), rules,
                            mesh) == shd.P("data")
    spec = shd.resolve_spec((1, 16), ("act_batch", "act_kv"), rules, mesh)
    assert spec == shd.P(None, "data")


@given(st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 40, 41]), min_size=1,
                max_size=4))
def test_resolver_always_legal(dims):
    """Whatever the shapes, the resolved spec never over-shards a dim and
    never reuses a mesh axis; and it is the reference's."""
    mesh = shd.Mesh((2, 2), ("data", "model"))
    rules = {"a": "data", "b": "model", "c": "model", "d": "data"}
    logical = tuple("abcd"[: len(dims)])
    spec = shd.resolve_spec(tuple(dims), logical, rules, mesh)
    flat = []
    for e in spec:
        if e is not None:
            flat += list(e) if isinstance(e, tuple) else [e]
    assert len(flat) == len(set(flat))
    for dim, entry in zip(dims, list(spec) + [None] * 4):
        if entry is not None:
            assert dim % shd.axis_size(mesh, entry) == 0
    ref = ref_shd.resolve_spec(tuple(dims), logical, rules,
                               _stub_mesh((2, 2), ("data", "model")))
    assert tuple(ref) == tuple(spec)


def test_rule_profiles_are_the_reference_tables():
    assert shd.RULE_PROFILES == ref_shd.RULE_PROFILES


# -------------------------------------------------- model and state specs
def _resolved_equal(shapes: dict, port_specs: dict, ref_specs: dict):
    """Every leaf resolves alike under every profile on both meshes."""
    for shape, names in MESHES.items():
        pm = shd.Mesh(shape, names)
        jm = _stub_mesh(shape, names)
        assert (shd.batch_axes(pm)
                == ref_shd.batch_axes(jm))
        for profile, rules in shd.RULE_PROFILES.items():
            for path, spec in port_specs.items():
                got = shd.resolve_spec(shapes[path], spec, rules, pm)
                want = ref_shd.resolve_spec(shapes[path], ref_specs[path],
                                            ref_shd.RULE_PROFILES[profile],
                                            jm)
                assert tuple(got) == tuple(want), (profile, path, shape)


def _port_cache_shapes(model, batch: int, seq: int) -> dict:
    """Cache leaf path -> the reference's (stacked) shape, from the port's
    per-layer caches on ``meta``."""
    caches = model.init_caches(batch, seq)
    parts = caches.items() if isinstance(caches, dict) else [("", caches)]
    specs = model.cache_specs(seq)
    rows: dict = {}
    for part, layers in parts:
        for i, cache in enumerate(layers):
            prefix, row = model.layer_cache_paths(i)
            key = (f"{part}/" if part else "") + prefix
            for name, t in cache.items():
                path = next(p for p in (key + name, f"{key}attn/{name}",
                                        f"{key}mamba/{name}") if p in specs)
                rows.setdefault(path, [tuple(t.shape), 0, row is not None])
                rows[path][1] += 1
    return {p: ((n,) + s if stacked else s)
            for p, (s, n, stacked) in rows.items()}


@pytest.mark.parametrize("arch_id", sorted(REGISTRY))
def test_param_cache_and_state_specs_match_reference(arch_id):
    for size in ("full", "smoke"):
        cfg = getattr(get_arch(arch_id), size)
        ref_model = ref_build_model(getattr(ref_get_arch(arch_id), size))
        model = build_model(cfg, "meta")
        # parameters: leaf for leaf, in group_params' order
        port_specs = model.param_specs()
        ref_specs = _flat(ref_model.param_specs())
        assert port_specs == ref_specs, (arch_id, size)
        leaves = group_params(model)
        assert list(port_specs) == list(leaves)
        shapes = {p: stacked_shape(v) for p, v in leaves.items()}
        _resolved_equal(shapes, port_specs, ref_specs)
        # caches at a decode shape (ring caches at the window included)
        seq = 64 if size == "smoke" else 32768
        port_cache = model.cache_specs(seq)
        ref_cache = _flat(ref_model.cache_specs(seq))
        assert port_cache == ref_cache, (arch_id, size)
        cshapes = _port_cache_shapes(model, 8, seq)
        assert set(cshapes) == set(port_cache)
        _resolved_equal(cshapes, port_cache, ref_cache)
        # optimizer state: AdamW with a float32 master, Adafactor
        ref_params = {}
        for path, leaf in leaves.items():
            node = ref_params
            *parents, last = path.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = jax.ShapeDtypeStruct(
                stacked_shape(leaf), _JAX_DTYPES[members(leaf)[0].dtype])
        for name, kw in (("adamw", dict(master_fp32=True)),
                         ("adafactor", {})):
            pcfg = opt_mod.OptimizerConfig(name=name, **kw)
            rcfg = ref_opt.OptimizerConfig(name=name, **kw)
            got = opt_mod.state_specs(pcfg, leaves, port_specs)
            want = ref_opt.state_specs(rcfg, ref_params,
                                       ref_model.param_specs())
            assert got.step == tuple(want.step) == ()
            got_flat = {f"{p}/{k}": v for p, st_ in got.inner.items()
                        for k, v in st_.items()}
            assert got_flat == _flat(want.inner), (arch_id, size, name)
            if name == "adamw":
                assert all(("master" in s_) == (members(leaves[p])[0].dtype
                                                != torch.float32)
                           for p, s_ in got.inner.items())


def test_production_meshes():
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert shd.batch_axes(multi) == ("pod", "data")
    # the pod axis joins the batch only
    rules = shd.RULE_PROFILES["serve"]
    assert shd.resolve_spec((32, 7), ("act_batch", None), rules,
                            multi) == shd.P(("pod", "data"))
    assert shd.batch_spec(multi, (32, 8)) == shd.P(("pod", "data"))
    assert shd.batch_spec(multi, (1, 8)) == shd.P()
    assert shd.shard_shape((32, 8, 48), shd.P(("pod", "data"), None,
                                              "model"), multi) == (1, 8, 3)
    with pytest.raises(ValueError, match="divide"):
        shd.shard_shape((3,), shd.P("data"), single)


# ------------------------------------------------------------- ShardSpec
@pytest.mark.parametrize("axis", ["cells", "fleet"])
def test_shard_spec_leaf_and_tree_specs_match_reference(axis):
    tree = {"a": torch.zeros(8, 3), "b": (torch.zeros(6), torch.zeros(())),
            "c": [torch.zeros(4, 2, 2)]}
    ref_tree = jax.tree_util.tree_map(lambda t: np.zeros(t.shape), tree)
    pm = shd.Mesh((4,), (axis,))
    jm = _stub_mesh((4,), (axis,))
    got = ShardSpec(axis=axis).tree_specs(tree, pm)
    want = RefShardSpec(axis=axis).tree_specs(ref_tree, jm)
    assert jax.tree_util.tree_map(tuple, got,
                                  is_leaf=lambda x: isinstance(x, shd.P)) \
        == jax.tree_util.tree_map(tuple, want,
                                  is_leaf=lambda x: isinstance(x, JP))
    assert got["a"] == shd.P(axis) and got["b"][0] == shd.P()
    assert ShardSpec(axis=axis).leaf_spec(torch.zeros(()), pm) == shd.P()


# ------------------------------------------------------------------ hooks
def test_constraints_are_identity_without_a_context():
    x = torch.randn(4, 3, 2)
    assert shd.constrain_act(x) is x
    assert shd.constrain_named(x, ("experts", "act_capacity", None)) is x
    seen = []
    with shd.activation_constraints(None, "train_seqshard",
                                    record=lambda t, lg: seen.append(lg)
                                    or t):
        assert shd.constrain_act(x) is x
        shd.constrain_named(x, ("experts", None, None))
    assert seen == [("act_batch", "act_seq", None),
                    ("experts", None, None)]
    with shd.activation_constraints(None, "train"):
        assert shd.constrain_act(x) is x


def test_placements_and_local_shapes_on_a_one_rank_mesh():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_debug_mesh(1, 1, device="cpu")
    try:
        assert shd.to_placements(shd.P("data", "model"), mesh) == (
            Shard(0), Shard(1))
        assert shd.to_placements(shd.P(None, ("data", "model")), mesh) == (
            Shard(1), Shard(1))
        assert shd.to_placements(shd.P(), mesh) == (Replicate(),
                                                    Replicate())
        model = build_model(get_arch("internlm2-1.8b").smoke, "cpu")
        specs = model.param_specs()
        for path, leaf in group_params(model).items():
            spec = shd.resolve_spec(stacked_shape(leaf), specs[path],
                                    shd.RULE_PROFILES["train"], mesh)
            row = spec[1:] if isinstance(leaf, list) else spec
            for p in members(leaf):
                d = distribute_tensor(p.detach(), mesh,
                                      shd.to_placements(row, mesh))
                assert tuple(d.to_local().shape) == shd.shard_shape(
                    tuple(p.shape), row, mesh)
        # a DTensor is redistributed under a context
        x = distribute_tensor(torch.randn(4, 6, 8), mesh,
                              (Replicate(), Replicate()))
        with shd.activation_constraints(mesh, "train"):
            y = shd.constrain_act(x)
        assert y.placements == shd.to_placements(
            shd.resolve_spec((4, 6, 8), ("act_batch", None, None),
                             shd.RULE_PROFILES["train"], mesh), mesh)
    finally:
        dist.destroy_process_group()


def test_resolve_device_takes_meta():
    assert resolve_device("meta") == torch.device("meta")
    model = build_model(get_arch("jamba-1.5-large-398b").full, "meta")
    assert model.device == torch.device("meta")
    assert sum(p.numel() for p in model.parameters()) > 390e9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda")
