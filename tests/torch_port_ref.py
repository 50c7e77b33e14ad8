"""Reference-side helpers shared by the PyTorch port's parity tests.

The port (``repro_torch``) never reproduces JAX's threefry draws; it takes
every random draw as an operand.  :class:`JaxChainNoise` replays the JAX
reference engine's per-tick key chain (``repro/api/engine.py::_key_block``:
``k, k_env, k_agents = split(k, 3)``, an R-way per-cell split, then a
fast/slow split per cell) and hands the port exactly the numbers the
reference draws from it:

* the Gumbel noise of the action categorical at ``k_fast``
  (``jax.random.categorical`` is ``argmax(logits + gumbel(key))``),
* the Thompson bandit's standard-normal sampling noise at ``k_fast``,
* the replay indices of ``sample_batch`` at the boundary tick's ``k_slow``,
* the two restart uniforms of ``fluid_window_step`` at ``split(k_env)``.

For the single-router serving path, :class:`RouterKeyChainNoise` replays
the reference ``AifRouter``'s chain instead (``key, k = split(key)`` per
tick, then ``tick``'s ``k_fast, k_slow = split(k)``): the Gumbel noise of
``select_action`` at ``k_fast`` and the replay indices at ``k_slow``.

The rest converts between the packages: topologies, reference pytrees to
the dicts of numpy leaves that ``repro_torch``'s ``*_from_numpy`` take
(:func:`lm_to_port` carries a reference LM's parameter and cache trees
across, decoder-only, hybrid or encoder-decoder; :func:`moe_to_port` one
MoE layer's parameters; :func:`train_state_to_port` a reference train
state with its optimizer state and error-feedback buffers), and port
tensors back to numpy; :func:`expert_indices` records both sides' MoE
routing.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import topology as ref_topology
from repro_torch.core import topology as port_topology

# The test runner starts several workers on one machine.
torch.set_num_threads(1)

#: Parity tolerance: both sides compute in float32 but sum in different
#: orders (XLA vs PyTorch reductions), so floats agree to rounding, not bits.
RTOL, ATOL = 1e-4, 1e-6


def two_tier_ref() -> ref_topology.Topology:
    return ref_topology.Topology(tier_names=("edge", "cloud"),
                                 tier_classes=("edge-light", "server"))


def port_topo(topo: ref_topology.Topology) -> port_topology.Topology:
    """The port's :class:`Topology` with the same fields as ``topo``."""
    spec = port_topology.PolicySpec(
        **{f.name: getattr(topo.policy_spec, f.name)
           for f in dataclasses.fields(topo.policy_spec)})
    fields = {f.name: getattr(topo, f.name) for f in dataclasses.fields(topo)}
    fields["policy_spec"] = spec
    return port_topology.Topology(**fields)


def ref_topologies() -> list[ref_topology.Topology]:
    """K = 2, 3 (the paper's testbed) and 5."""
    return [two_tier_ref(), ref_topology.default_topology(),
            ref_topology.five_tier_topology()]


def to_numpy(tree):
    """A reference pytree of NamedTuples as nested dicts of numpy arrays
    (None leaves stay None)."""
    if tree is None:
        return None
    if hasattr(tree, "_asdict"):
        return {k: to_numpy(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def t2n(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def assert_close(port, ref, rtol=RTOL, atol=ATOL, err_msg=""):
    port = t2n(port) if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def assert_tree_close(port, ref, rtol=RTOL, atol=ATOL, path="state"):
    """Leaf-by-leaf comparison of a port NamedTuple with the reference's;
    integer and bool leaves must be equal."""
    if hasattr(ref, "_asdict"):
        for k, v in ref._asdict().items():
            if v is None:
                continue
            assert_tree_close(getattr(port, k), v, rtol, atol, f"{path}.{k}")
        return
    r = np.asarray(ref)
    if r.dtype.name == "bfloat16":
        r = r.astype(np.float32)
    p = t2n(port) if isinstance(port, torch.Tensor) else np.asarray(port)
    if r.dtype.kind in "biu":
        np.testing.assert_array_equal(p.astype(r.dtype), r, err_msg=path)
    else:
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol, err_msg=path)


class JaxChainNoise:
    """The reference engine's draws, as a ``repro_torch.noise`` source.

    Replays the per-tick key chain from ``jax.random.key(seed)`` (or from
    ``key``) for ``n_steps`` ticks of an ``r``-cell fleet.  Call it in the
    same PRNG mode as the reference run it is compared with.
    """

    def __init__(self, seed: int, r: int, n_steps: int, key=None):
        k = jax.random.key(seed) if key is None else key
        self.k_env, self.k_fast, self.k_slow = [], [], []
        for _ in range(n_steps):
            k, k_env, k_agents = jax.random.split(k, 3)
            ks = jax.vmap(jax.random.split)(jax.random.split(k_agents, r))
            self.k_env.append(k_env)
            self.k_fast.append(ks[:, 0])
            self.k_slow.append(ks[:, 1])

    def gumbel(self, t, shape):
        a = shape[-1]
        g = jax.vmap(lambda k: jax.random.gumbel(k, (a,)))(self.k_fast[t])
        return torch.tensor(np.asarray(g))

    def normal(self, t, shape):
        a = shape[-1]
        e = jax.vmap(lambda k: jax.random.normal(k, (a,)))(self.k_fast[t])
        return torch.tensor(np.asarray(e))

    def replay_indices(self, t, size, batch):
        sizes = jnp.asarray(t2n(size), jnp.int32)
        idx = jax.vmap(lambda k, n: jax.random.randint(
            k, (batch,), 0, jnp.maximum(n, 1)))(self.k_slow[t], sizes)
        return torch.tensor(np.asarray(idx), dtype=torch.int64)

    def env_uniforms(self, t, shape):
        return env_uniforms(self.k_env[t], shape)


def env_uniforms(key, shape):
    """``fluid_window_step``'s restart uniforms for ``key``, as tensors."""
    k_fire, k_dur = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.uniform(k_fire, shape))),
            torch.tensor(np.asarray(jax.random.uniform(k_dur, shape))))


class RunFluidNoise:
    """``repro.envsim.batched.run_fluid``'s per-window env keys
    (``split(key, T)``) as a noise source of restart uniforms."""

    def __init__(self, key, n_steps: int):
        self.keys = jax.random.split(key, n_steps)

    def env_uniforms(self, t, shape):
        return env_uniforms(self.keys[t], shape)


def port_to_numpy(tree):
    """A port NamedTuple of tensors as nested dicts of numpy arrays (bf16
    leaves widen to float32, None leaves stay None)."""
    if tree is None:
        return None
    if hasattr(tree, "_asdict"):
        return {k: port_to_numpy(v) for k, v in tree._asdict().items()}
    return t2n(tree)


def mega_state_to_port(state, cfg, slot_dtype=None):
    """The reference's :class:`repro.core.mega.MegaFleetState` (or a dict
    of numpy leaves) as the port's, on the CPU; ``slot_dtype`` None keeps
    the source's slot type."""
    from repro_torch.core import mega
    arrays = state if isinstance(state, dict) else to_numpy(state)
    return mega.mega_state_from_numpy(arrays, cfg, "cpu", slot_dtype)


def mega_state_to_ref(arrays: dict, slot_dtype=jnp.float32):
    """A :func:`port_to_numpy` dict of the port's ``MegaFleetState`` as the
    reference's (int32 indices, ``slot_dtype`` slot planes; a warm fleet's
    ``b_base`` baseline carried along)."""
    from repro.core import mega as ref_mega

    def f32(x):
        return jnp.asarray(x, jnp.float32)

    def i32(x):
        return jnp.asarray(x, jnp.int32)

    sl = arrays["slots"]
    slots = ref_mega.MegaSlots(
        q_prev=jnp.asarray(sl["q_prev"], slot_dtype),
        q_next=jnp.asarray(sl["q_next"], slot_dtype),
        obs_bins=i32(sl["obs_bins"]), obs_mask=f32(sl["obs_mask"]),
        action=i32(sl["action"]), dt_since_change=f32(sl["dt_since_change"]),
        wcount=f32(sl["wcount"]))
    b_base = arrays["cache"].get("b_base")
    cache = ref_mega.MegaCache(
        **{k: f32(v) for k, v in arrays["cache"].items() if k != "b_base"},
        b_base=None if b_base is None else f32(b_base))
    return ref_mega.MegaFleetState(
        a_counts=f32(arrays["a_counts"]), slots=slots, cache=cache,
        belief=f32(arrays["belief"]), prev_action=i32(arrays["prev_action"]),
        dt_since_change=f32(arrays["dt_since_change"]),
        error_ema=f32(arrays["error_ema"]),
        unstable=jnp.asarray(arrays["unstable"], bool), t=i32(arrays["t"]))


def assert_bits_equal(a, b):
    """Every tensor leaf of the port trees ``a`` and ``b`` equal to the bit
    (the same leaves, by path)."""
    from repro_torch.checkpoint.checkpointer import flatten
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        assert torch.equal(fa[name], fb[name]), name


def agent_state_to_port(state, cfg):
    """The reference's dense per-tick ``AgentState`` (a fleet carry) as the
    port's, on the CPU."""
    from repro_torch.core import fleet
    return fleet.agent_state_from_numpy(to_numpy(state), cfg, "cpu")


def clone_tree(tree):
    """A copy of a port NamedTuple of tensors (None leaves stay None): the
    port updates some carries in place."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    leaves = [clone_tree(x) for x in tree]
    return type(tree)(*leaves) if hasattr(tree, "_fields") else \
        type(tree)(leaves)


class RouterKeyChainNoise:
    """The reference ``repro.envsim.routers.AifRouter(seed=seed)``'s draws
    over ``n_ticks`` ticks, as a ``repro_torch.noise`` source for the port's
    single-router :func:`repro_torch.core.agent.tick` (R=1)."""

    def __init__(self, seed: int, n_ticks: int):
        key = jax.random.key(seed)
        self.k_fast, self.k_slow = [], []
        for _ in range(n_ticks):
            key, k = jax.random.split(key)
            k_fast, k_slow = jax.random.split(k)
            self.k_fast.append(k_fast)
            self.k_slow.append(k_slow)

    def gumbel(self, t, shape):
        g = jax.random.gumbel(self.k_fast[t], (shape[-1],))
        return torch.tensor(np.asarray(g))[None]

    def replay_indices(self, t, size, batch):
        n = jnp.maximum(jnp.asarray(int(t2n(size)[0]), jnp.int32), 1)
        idx = jax.random.randint(self.k_slow[t], (batch,), 0, n)
        return torch.tensor(np.asarray(idx), dtype=torch.int64)[None]


def bandit_carry_to_port(carry):
    """A reference bandit or round-robin carry (``ThompsonCarry``,
    ``UcbCarry`` or the (R,) counter) as the port's, on the CPU."""
    from repro_torch.api import router

    def leaf(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.int64 if x.dtype.kind in "iu"
                            else torch.float32)

    if not hasattr(carry, "_asdict"):
        return leaf(carry)
    port_cls = getattr(router, type(carry).__name__)
    return port_cls(**{k: leaf(v) for k, v in carry._asdict().items()})


def snapshot_to_port(snapshot):
    """A reference resume snapshot (per-tick: the five telemetry arrays and
    the chain key; mega: (telemetry, chain key)) as the port's: the
    telemetry carry and no noise position, which a :class:`JaxChainNoise`
    indexed by tick does not need."""
    obs = snapshot[0] if len(snapshot) == 2 else snapshot[:5]
    return (tuple(torch.tensor(np.asarray(x)) for x in obs), None)


def lm_to_port(cfg, params=None, caches=None):
    """A reference LM's parameter tree and/or cache tree as the port's
    ``state_dict`` / per-layer cache list (``{"self", "cross"}`` lists for
    an encoder-decoder) on the CPU, through the numpy converters of
    :mod:`repro_torch.models.convert`; ``cfg`` is the port's
    ``ModelConfig``.  Returns (state_dict or None, caches or None)."""
    from repro_torch.models import convert
    sd = (None if params is None else
          convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params)))
    cl = (None if caches is None else
          convert.caches_from_numpy(cfg, jax.tree.map(np.asarray, caches)))
    return sd, cl


@contextlib.contextmanager
def expert_indices():
    """Record the top-k expert indices of every MoE layer call on both
    sides, in call order: yields (ref, port), two lists that the
    reference's ``apply_moe`` (from inside its jitted code, through an
    ordered debug callback; only in functions traced inside the block) and
    the port's ``Moe.route`` append one (N, K) array a call to.  The
    reference's are complete when the block exits."""
    import repro.models.moe as ref_moe
    from repro_torch.models import moe
    ref_seen, port_seen = [], []
    apply, route = ref_moe.apply_moe, moe.Moe.route

    def ref_recording(p, x, cfg):
        xf = x.reshape(-1, x.shape[-1])
        logits = (xf @ p["router"].astype(xf.dtype)).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        jax.debug.callback(lambda i: ref_seen.append(np.asarray(i)), idx,
                           ordered=True)
        return apply(p, x, cfg)

    def port_recording(self, xf):
        out = route(self, xf)
        port_seen.append(out[2].detach().cpu().numpy().copy())
        return out
    ref_moe.apply_moe, moe.Moe.route = ref_recording, port_recording
    try:
        yield ref_seen, port_seen
        jax.effects_barrier()
    finally:
        ref_moe.apply_moe, moe.Moe.route = apply, route


def moe_to_port(cfg, params):
    """A reference MoE layer (``repro.models.moe.init_moe``'s tree) as a
    port :class:`repro_torch.models.moe.Moe` on the CPU with those
    weights."""
    from repro_torch.models import convert, moe
    m = moe.Moe(cfg, "meta")
    m.load_state_dict({k: convert.tensor_from_numpy(v) for k, v in
                       convert._flatten(jax.tree.map(np.asarray,
                                                     params)).items()},
                      assign=True)
    return m


def port_train_config(tcfg):
    """The port's ``TrainConfig`` with the fields of the reference's."""
    from repro_torch.training import grad_compression, optimizer
    from repro_torch.training.train_step import TrainConfig
    return TrainConfig(
        optimizer=optimizer.OptimizerConfig(
            **dataclasses.asdict(tcfg.optimizer)),
        compression=grad_compression.CompressionConfig(
            **dataclasses.asdict(tcfg.compression)),
        moe_aux_weight=tcfg.moe_aux_weight, accum_steps=tcfg.accum_steps)


def train_state_to_port(cfg, tcfg, state):
    """A reference ``TrainState`` as the port's (model, state, train
    config) on the CPU, through
    :func:`repro_torch.models.convert.train_state_from_numpy`; ``cfg`` is
    the port's ``ModelConfig``, ``tcfg`` the reference's ``TrainConfig``."""
    from repro_torch.models import convert
    ptcfg = port_train_config(tcfg)
    model, st = convert.train_state_from_numpy(
        cfg, ptcfg, jax.tree.map(np.asarray, state), "cpu")
    return model, st, ptcfg


def batch_to_port(batch):
    """A reference batch (dict of arrays) as CPU tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
